"""The port's ring attention against the JAX package's, on the CPU.

JAX runs ``apex_tpu.ops.ring_attention`` under ``shard_map`` with cp=4 on
the virtual CPU devices (as ``tests/test_context_parallel.py`` does, on
its plain path: the chunk functions meet JAX's interpret kernels in
``test_torch_flash_chunk.py``), forward and ``jax.vjp`` inside the map
with the sharded cotangent. The port runs the same schedule for all four
ranks in one process (``_ring_attention_local``). Numpy-made q, k, v and
cotangent at b 2, 4 heads, s 32 (chunks of 8), head_dim 16: causal and
not, global ``kv_lengths`` crossing chunks (9, 32, 17), window 11 at s 32
(the shape of ``test_context_parallel.py``'s ``test_window_grads_match``),
GQA 4 over 2.

Bars: o rtol and atol 2e-5; each grad element within 1e-6 x the largest
|grad| of the reference (JAX's own ring reaches 2.8e-7 of it in the
window case, where non-ring flash's ds cancels to 0 at row 0 and the
ring's, from the merged o, to 1.3-1.8e-3 of grads near 6,250). The
port's ring is held to JAX's ring and to the port's non-ring
``flash_attention`` under the same bars.

In bf16 the port's ring (over the plain chunk versions, which round ds
and p where Kernel I does) is held to JAX's ring, forward, and backward
on the port's residuals, within bars summed from the chunk bars
(``chip_smoke.py``'s ``_o_bar`` and ``_PlainChunks.grad_bar``).

Then the group ring: four processes (spawned, gloo, a ``FileStore`` under
the test's temporary directory, a 60 s group timeout, each joined with
its own limit) give the single-process schedule's o and grads bit for
bit, in f32 and bf16, and a group of size 1 gives ``flash_attention``.
``group=None`` degrades to ``flash_attention`` bit for bit.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops.ring_attention import _ring_vjp_bwd
from apex_tpu.ops.ring_attention import ring_attention as jax_ring
from apex_tpu.transformer import parallel_state
from apex_tpu.utils.sharding import shard_map
from apex_tpu_torch.ops import LAUNCHES, flash_attention, ring_attention
from apex_tpu_torch.ops.attention import flash_fwd_plain
from apex_tpu_torch.ops.ring_attention import (
    _ring_attention_local,
    _ring_bwd,
    _ring_fwd,
)
from chip_smoke import _o_bar, _plain_ring, _PlainChunks

import torch_ring_worker

CP = 4
#: name: (b, h, kvh, kwargs)
CASES = {
    "causal": (2, 4, 4, dict(causal=True)),
    "full": (2, 4, 4, dict(causal=False)),
    "kv_lengths_across_chunks": (3, 4, 4, dict(causal=True,
                                               kv_lengths=[9, 32, 17])),
    "window_11": (2, 4, 4, dict(causal=True, sliding_window=11)),
    "gqa_4_over_2": (2, 4, 2, dict(causal=True)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_plain(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _inputs(name, dtype=torch.float32, seed=0):
    """q, k, v and the cotangent over the whole sequence, and the port's
    keywords (``kv_lengths`` as an int32 tensor)."""
    b, h, kvh, kw = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(dtype) for shape in ((b, h, 32, 16), (b, kvh, 32, 16),
                                            (b, kvh, 32, 16), (b, h, 32, 16)))
    kw = dict(kw)
    if "kv_lengths" in kw:
        kw["kv_lengths"] = torch.tensor(kw["kv_lengths"], dtype=torch.int32)
    return q, k, v, do, kw


def _jax_ring(q, k, v, do, kw):
    """JAX's ring over cp=4 virtual devices: ``(o, (dq, dk, dv))``."""
    jkw = dict(kw)
    if "kv_lengths" in jkw:
        jkw["kv_lengths"] = jnp.asarray(jkw["kv_lengths"].numpy())
    spec = P(None, None, "context")

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: jax_ring(a, b, c, **jkw), q, k, v)
        return o, vjp(do)

    parallel_state.destroy_model_parallel()
    try:
        mesh = parallel_state.initialize_model_parallel(
            context_parallel_size=CP)
        out = jax.jit(shard_map(fwd_bwd, mesh=mesh, in_specs=(spec,) * 4,
                                out_specs=(spec, (spec,) * 3),
                                check_vma=False))(
            *(jnp.asarray(t.numpy()) for t in (q, k, v, do)))
    finally:
        parallel_state.destroy_model_parallel()
    return np.asarray(out[0]), [np.asarray(g) for g in out[1]]


def _local_ring(q, k, v, do, kw):
    """The port's single-process schedule: o and grads, whole sequences."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    chunks = [t.chunk(CP, dim=2) for t in leaves]
    o = torch.cat(_ring_attention_local(*chunks, **kw), dim=2)
    o.backward(do)
    return o.detach(), [t.grad for t in leaves]


def _flash(q, k, v, do, kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, **kw)
    o.backward(do)
    return o.detach(), [t.grad for t in leaves]


def _check(want_o, want_grads, o, grads):
    np.testing.assert_allclose(np.asarray(o), want_o, rtol=2e-5, atol=2e-5)
    for name, w, g in zip(("dq", "dk", "dv"), want_grads, grads):
        w = np.asarray(w)
        bar = 1e-6 * np.abs(w).max()
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=bar,
                                   err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax_ring_and_flash(jax_plain, name):
    """The port's ring (all four ranks in one process, the plain chunk
    versions) against JAX's ring at cp=4 and against the port's non-ring
    ``flash_attention``, forward and grads."""
    q, k, v, do, kw = _inputs(name)
    before = dict(LAUNCHES)
    o, grads = _local_ring(q, k, v, do, kw)
    assert LAUNCHES == before            # CPU tensors launch no kernel
    _check(*_jax_ring(q, k, v, do, kw), o, grads)
    fo, fgrads = _flash(q, k, v, do, kw)
    _check(fo.numpy(), [g.numpy() for g in fgrads], o, grads)


def test_bf16_ring_keeps_jax_rounding_points(jax_plain):
    """In bf16 the ring rounds each chunk's o to bf16 before the fp32
    merge, takes delta from the rounded o and sums each chunk's bf16
    grads in fp32, as JAX's ring does: its o is held to JAX's within
    ``_o_bar`` (each chunk's o 1 ulp apart, merged), and JAX's backward
    (``_ring_vjp_bwd``) on the port's o and lse to the port's within
    ``_PlainChunks.grad_bar`` (each chunk call's 1 ulp plus the slack of
    the ds and p the port rounds where JAX's plain path does not)."""
    q, k, v, do, _ = _inputs("gqa_4_over_2", torch.bfloat16, seed=2)
    kvl, window, scale = torch.tensor([30, 13], dtype=torch.int32), 11, 0.25
    plain = _PlainChunks()
    ring = _plain_ring(CP, plain)
    qs, ks, vs, dos = (list(t.chunk(CP, dim=2)) for t in (q, k, v, do))
    os, lses = _ring_fwd(ring, qs, ks, vs, kvl, True, window, scale)
    grads = _ring_bwd(ring, qs, ks, vs, kvl, os, lses, dos, True, window,
                      scale)
    jkvl = jnp.asarray(kvl.numpy())
    jx = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa
    spec = P(None, None, "context")
    parallel_state.destroy_model_parallel()
    try:
        mesh = parallel_state.initialize_model_parallel(
            context_parallel_size=CP)
        jo = jax.jit(shard_map(
            lambda a, b, c: jax_ring(a, b, c, causal=True,
                                     sliding_window=window, kv_lengths=jkvl,
                                     softmax_scale=scale),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False))(jx(q), jx(k), jx(v))
        jgrads = jax.jit(shard_map(
            lambda a, b, c, o, lse, g: _ring_vjp_bwd(
                True, window, scale, "context", (a, b, c, jkvl, o, lse),
                g)[:3],
            mesh=mesh, in_specs=(spec,) * 6, out_specs=(spec,) * 3,
            check_vma=False))(jx(q), jx(k), jx(v),
                              jx(torch.cat(os, dim=2)),
                              jnp.asarray(torch.cat(lses, dim=2).numpy()),
                              jx(do))
    finally:
        parallel_state.destroy_model_parallel()
    as_torch = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32))).bfloat16()
    m_abs = flash_fwd_plain(q.float(), k.float(), v.float().abs(), kvl,
                            scale, True, window)[0].chunk(CP, dim=2)
    want_os = as_torch(jo).chunk(CP, dim=2)
    for r in range(CP):
        assert bool(((os[r].float() - want_os[r].float()).abs()
                     <= _o_bar(want_os[r], m_abs[r])).all()), r
        for name, got, jg in zip("qkv", grads, jgrads):
            want = as_torch(jg).chunk(CP, dim=2)[r]
            bar = plain.grad_bar(name, r * 8, want)
            assert bool(((got[r].float() - want.float()).abs()
                         <= bar).all()), (name, r)


def test_group_ring_equals_the_single_process_schedule(tmp_path):
    """cp=4 gloo processes give the single-process schedule's o and grads
    bit for bit (f32 window + GQA + kv_lengths, bf16 causal GQA); a group
    of size 1 gives ``flash_attention``."""
    q, k, v, do, _ = _inputs("gqa_4_over_2")
    kw = dict(causal=True, sliding_window=11,
              kv_lengths=torch.tensor([30, 13], dtype=torch.int32))
    bq, bk, bv, bdo, bkw = _inputs("gqa_4_over_2", torch.bfloat16, seed=1)
    cases = [(q, k, v, do, kw), (bq, bk, bv, bdo, bkw)]
    torch.save(cases, tmp_path / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_ring_worker.run, args=(
        r, CP, str(tmp_path / "store"), str(tmp_path / "inputs.pt"),
        str(tmp_path / f"rank{r}.pt"))) for r in range(CP)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 120
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * CP
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(CP)]
    assert all(r["size1_is_flash"] for r in ranks)
    for c, case in enumerate(cases):
        o, grads = _local_ring(*case)
        for t, want in enumerate((o, *grads)):
            got = torch.cat([r["results"][c][t] for r in ranks], dim=2)
            assert torch.equal(got, want), (c, t)


def test_degrades_to_flash_without_a_group():
    q, k, v, _, kw = _inputs("window_11", torch.bfloat16)
    assert torch.equal(ring_attention(q, k, v, **kw),
                       flash_attention(q, k, v, **kw))
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, k, v, sliding_window=4)
    with pytest.raises(ValueError, match="length"):
        _ring_attention_local(q.chunk(2, dim=2), (k,), (v,), causal=True)
