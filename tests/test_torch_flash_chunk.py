"""The port's chunk functions (Kernels B and I with global offsets) against
the JAX package, on the CPU.

``flash_chunk_fwd`` / ``flash_chunk_bwd`` take one (q chunk, kv chunk)
pair of a longer sequence whose first query and key sit at the global
positions ``q_start`` and ``k_start``. A global sequence of 64 positions in
chunks of 16 (numpy-made q, k, v and a cotangent) gives the pairs: before
the causal diagonal, on it, straddling it (the diagonal crosses the pair
partway, so its first rows see no key), wholly in the future (every tile
skipped: o 0, lse 1e30, zero grads), a far past that a window cuts and
one that a window skips; global ``kv_lengths`` that end inside, before
and after the key chunk; GQA 4 over 2; head dims 16, 32 and 64. The
backward takes the GLOBAL lse and delta, from the port's plain forward
over the whole sequence.

Both packages' chunk functions run in f32, bf16 and fp16 on JAX's plain
path (``_chunk_reference_fwd/bwd``), and five of the pairs in f32 or
bf16 on its Pallas kernels in interpret mode with 8 x 8 blocks (two
blocks of a chunk each way, so the offsets reach ``_causal_block_skip``).

Bars, as the 4D flash tests': f32 o atol 2e-5, grads atol 1e-4, lse 1e-5;
in bf16 and fp16 o within 1 ulp (against the interpret kernels plus one
rounding step of each p times |v|: the JAX kernel rounds p before P V),
and each grad within 1 ulp plus ``flash_bwd_rounding_slack`` (the port
rounds ds and p to the input dtype where JAX's kernels round them and its
plain path does not); against the interpret kernels at most 0.1% (bf16)
of the elements past 1 ulp; the 1-ulp floor ``backward_floor(d)``.

The emulated bf16 rounding plans of Kernels B (an online softmax over
64-key tiles, p split hi + lo) and I (ds and p rounded per 64-wide tile,
delta given) are held to the plain chunk versions at offsets, as
``tests/test_torch_attention.py`` holds them at the default offset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import attention as jatt
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.ops.attention import (
    _visible,
    backward_floor,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_chunk_bwd,
    flash_chunk_bwd_plain,
    flash_chunk_fwd,
    flash_chunk_fwd_plain,
    flash_fwd_plain,
    rounding_step,
)

S, C = 64, 16        # global length, chunk length

#: name: (q chunk, k chunk, h, kvh, d, causal, window, kv_lengths)
PAIRS = {
    "before_diagonal": (2, 0, 4, 4, 16, True, None, None),
    "on_diagonal_gqa": (1, 1, 4, 2, 16, True, None, None),
    "straddling": (1, 1.5, 4, 2, 32, True, None, None),
    "future": (0, 2, 4, 4, 16, True, None, None),
    "far_past_window_cuts": (3, 1, 4, 2, 16, True, 40, None),
    "far_past_window_skips": (3, 0, 4, 4, 16, True, 20, None),
    "kv_lengths_inside_before_after": (2, 1, 4, 2, 16, True, None,
                                       [20, 10, 40]),
    "full_kv_lengths_d64": (0, 3, 4, 2, 64, False, None, [64, 55, 30]),
    "diagonal_window_gqa": (2, 2, 4, 2, 16, True, 11, [64, 37, 64]),
}
#: the pairs whose chunk sees no key at all
EMPTY = ("future", "far_past_window_skips")
#: (pair, dtype) on JAX's interpret-mode kernels (~2 s each to trace)
INTERPRET = [("on_diagonal_gqa", "float32"), ("straddling", "float32"),
             ("far_past_window_cuts", "float32"),
             ("kv_lengths_inside_before_after", "bfloat16"),
             ("straddling", "bfloat16")]
DTYPES = ["float32", "bfloat16", "float16"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(name, dtype, seed=0):
    """The pair's chunks, the global lse and delta of their query rows,
    and the port's arguments ``(kv_lengths, scale, causal, window,
    q_start, k_start)``."""
    i, j, h, kvh, d, causal, window, kvl = PAIRS[name]
    b = 2 if kvl is None else len(kvl)
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(dtype) for shape in ((b, h, S, d), (b, kvh, S, d),
                                            (b, kvh, S, d), (b, h, S, d)))
    tkvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    o, lse = flash_fwd_plain(q, k, v, tkvl, scale, causal, window)
    delta = (do.float() * o.float()).sum(-1)
    q_start, k_start = int(i * C), int(j * C)
    rows, cols = slice(q_start, q_start + C), slice(k_start, k_start + C)
    return ((q[:, :, rows], k[:, :, cols], v[:, :, cols], do[:, :, rows],
             lse[:, :, rows], delta[:, :, rows]),
            (tkvl, scale, causal, window, q_start, k_start))


def _jax(fn, *tensors, args, jdt, **blocks):
    """JAX's ``flash_chunk_fwd`` or ``flash_chunk_bwd`` on ``tensors``
    (the 16-bit ones in ``jdt``, lse and delta fp32)."""
    kvl, scale, causal, window, q_start, k_start = args
    jx = [jnp.asarray(_f32(t), jdt) for t in tensors[:4]] + \
        [jnp.asarray(t.numpy()) for t in tensors[4:]]
    return fn(*jx, q_start=q_start, k_start=k_start, causal=causal,
              window=window, softmax_scale=scale,
              kv_lengths=None if kvl is None else jnp.asarray(kvl.numpy()),
              **blocks)


def _check(name, want, got, dtype, slack=0.0, max_past_ulp=1.0,
           floor=2.0 ** -8):
    """f32: o atol 2e-5, lse 1e-5, grads 1e-4. 16-bit: every element
    within 1 ulp (eps of the magnitude, floored at magnitude ``floor``)
    plus ``slack``, at most ``max_past_ulp`` of them past 1 ulp."""
    want, got = _f32(want), _f32(got)
    if dtype == torch.float32 or name == "lse":
        atol = {"o": 2e-5, "lse": 1e-5}.get(name, 1e-4)
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-6,
                                   err_msg=name)
        return
    eps = float(torch.finfo(dtype).eps)
    one = floor * eps + eps * np.abs(want)
    e = np.abs(got - want)
    if isinstance(slack, torch.Tensor):
        slack = _f32(slack)
    assert (e - one - slack).max() <= 0, f"{name} past the bound"
    assert (e > one).mean() <= max_past_ulp, \
        f"{name}: {(e > one).mean()} of the elements past 1 ulp"


def _check_empty(name, o, lse, grads):
    if name in EMPTY:
        assert bool((lse == 1e30).all()) and not o.any()
        assert not any(g.any() for g in grads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(PAIRS))
def test_chunk_plain_matches_jax_plain(jax_mode, name, dtype):
    """The port's chunk functions on CPU tensors (their plain versions,
    no launch) against JAX's ``_chunk_reference_fwd/bwd``."""
    jax_mode("off")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    (q, k, v, do, lse_g, delta), args = _pair(name, tdt)
    kw = dict(q_start=args[4], k_start=args[5], causal=args[2],
              window=args[3], kv_lengths=args[0], softmax_scale=args[1])
    before = dict(LAUNCHES)
    o, lse = flash_chunk_fwd(q, k, v, **kw)
    grads = flash_chunk_bwd(q, k, v, do, lse_g, delta, **kw)
    assert LAUNCHES == before            # CPU tensors launch no kernel
    jo, jlse = _jax(jatt.flash_chunk_fwd, q, k, v, args=args, jdt=jdt)
    _check("o", jo, o, tdt)
    _check("lse", jlse, lse, tdt)
    want = _jax(jatt.flash_chunk_bwd, q, k, v, do, lse_g, delta, args=args,
                jdt=jdt)
    slack = flash_bwd_rounding_slack(q, k, v, do, None, lse_g, *args,
                                     delta=delta)
    for n, w, g, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g, tdt, sl, floor=backward_floor(q.shape[-1]))
    _check_empty(name, o, lse, grads)


@pytest.mark.parametrize("name,dtype", INTERPRET)
def test_chunk_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """The plain chunk versions against JAX's ``flash_chunk_fwd/bwd`` on
    the Pallas kernels in interpret mode, 8 x 8 blocks: the offsets reach
    ``_mask_block`` and the block skips (``_offsets`` :326)."""
    jax_mode("interpret")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    (q, k, v, do, lse_g, delta), args = _pair(name, tdt, seed=1)
    o, lse = flash_chunk_fwd_plain(q, k, v, *args)
    jo, jlse = _jax(jatt.flash_chunk_fwd, q, k, v, args=args, jdt=jdt,
                    block_q=8, block_k=8)
    group = q.shape[1] // k.shape[1]
    p, _ = flash_bwd_factors(q, k, v, do, None, lse, *args, delta=delta)
    _check("o", jo, o, tdt, torch.einsum(
        "bhqk,bhkd->bhqd", rounding_step(p, tdt),
        v.float().abs().repeat_interleave(group, dim=1)))
    _check("lse", jlse, lse, tdt)
    grads = flash_chunk_bwd_plain(q, k, v, do, lse_g, delta, *args)
    want = _jax(jatt.flash_chunk_bwd, q, k, v, do, lse_g, delta, args=args,
                jdt=jdt, block_q=8, block_k=8)
    slack = flash_bwd_rounding_slack(q, k, v, do, None, lse_g, *args,
                                     delta=delta)
    for n, w, g, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g, tdt, sl, max_past_ulp=1e-3,
               floor=backward_floor(q.shape[-1]))
    _check_empty(name, o, lse, grads)


def test_chunk_at_the_default_offsets_is_plain_flash():
    """``q_start = sk - sq``, ``k_start = 0`` is plain attention's mask:
    the chunk versions equal :func:`flash_fwd_plain` and the 4D
    backward bit for bit."""
    (q, k, v, do, _, _), _ = _pair("on_diagonal_gqa", torch.bfloat16)
    k, v = k[:, :, :12], v[:, :, :12]
    args = (torch.tensor([12, 7]), 0.25, True, 5)
    o, lse = flash_fwd_plain(q, k, v, *args)
    co, clse = flash_chunk_fwd_plain(q, k, v, *args, -4, 0)
    assert torch.equal(o, co) and torch.equal(lse, clse)
    delta = (do.float() * o.float()).sum(-1)
    want = flash_bwd_plain(q, k, v, do, o, lse, *args)
    got = flash_chunk_bwd_plain(q, k, v, do, lse, delta, *args, -4, 0)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


def test_chunk_validation():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_chunk_fwd(q, k, k, q_start=0, k_start=0)
    with pytest.raises(ValueError, match="seq, dim"):
        flash_chunk_fwd(q[0], k[0], k[0], q_start=0, k_start=0)


# ---------------------------------------------------------------------------
# Kernels B's and I's bf16 rounding plans at offsets, emulated
# ---------------------------------------------------------------------------

def _rows(q, k, args):
    """One (batch, head) pair a row of the leading dimension: ``(n, k/v
    repeated, the mask [b h, sq, sk])``, the mask at the pair's offsets."""
    kvl, _, causal, window, q_start, k_start = args
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    valid = _visible(sq, sk, kvl, causal, window, "cpu", q_start, k_start)
    valid = valid.expand(b, h, sq, sk).reshape(b * h, sq, sk)
    group = h // k.shape[1]
    return b * h, (lambda t: t.repeat_interleave(group, dim=1).reshape(
        b * h, sk, -1)), valid


def _kernel_b_emulation(q, k, v, args, tile=64):
    """Kernel B's bf16 arithmetic: an online softmax over ``tile``-key
    tiles with a running max, p split into bf16 hi + lo before its
    products with v, fp32 sums, o rounded once. Returns ``(o, lse)``."""
    b, h, sq, d = q.shape
    n, kv, valid = _rows(q, k, args)
    qf, kf, vf = q.reshape(n, sq, d).float(), kv(k).float(), kv(v).float()
    m = torch.full((n, sq, 1), -1e30)
    l = torch.zeros(n, sq, 1)
    acc = torch.zeros(n, sq, d)
    for c0 in range(0, kf.shape[1], tile):
        sl = slice(c0, c0 + tile)
        sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, sl]) * args[1]
        sc = torch.where(valid[:, :, sl], sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(sc == -1e30, torch.zeros(()), torch.exp(sc - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        acc = acc * alpha + hi @ vf[:, sl] + \
            (p - hi).bfloat16().float() @ vf[:, sl]
        m = m_new
    o = acc * torch.where(l > 0, 1.0 / l, torch.zeros(()))
    lse = torch.where(l > 0, m + torch.log(l), torch.tensor(1e30))
    return o.bfloat16().reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _kernel_i_emulation(q, k, v, do, lse, delta, args, tile=64):
    """Kernel I's bf16 arithmetic with the caller's delta: the dq pass
    over ``tile``-key tiles, the dk/dv pass over ``tile``-query tiles,
    each forming p = 2^((scale s - lse) log2 e) (0 where masked) and ds =
    p (dp - delta) in fp32 and rounding both to bf16 before their
    products; dk and dv summed over each group's heads in fp32. Returns
    ``(dq, dk, dv)`` in bf16."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    n, kv, valid = _rows(q, k, args)
    flat = lambda t: t.reshape(n, sq, -1).float()  # noqa: E731
    qf, dof, kf, vf = flat(q), flat(do), kv(k).float(), kv(v).float()
    lse, delta = lse.reshape(n, sq), delta.reshape(n, sq)

    def factors(rows, cols):
        x = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf[:, cols]) * args[1]
        x = torch.where(valid[:, rows, cols], x - lse[:, rows, None],
                        torch.tensor(-1e30))
        p = torch.exp2(x * 1.4426950408889634)
        dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], vf[:, cols])
        ds = p * (dp - delta[:, rows, None])
        return p.bfloat16().float(), ds.bfloat16().float()

    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, sk, tile):
        cols = slice(c0, c0 + tile)
        dq = dq + factors(slice(0, sq), cols)[1] @ kf[:, cols]
    for r0 in range(0, sq, tile):
        rows = slice(r0, r0 + tile)
        p, ds = factors(rows, slice(0, sk))
        dk = dk + ds.transpose(1, 2) @ qf[:, rows]
        dv = dv + p.transpose(1, 2) @ dof[:, rows]
    group = lambda t: t.reshape(b, kvh, h // kvh, sk, d).sum(2)  # noqa
    return ((dq * args[1]).reshape(b, h, sq, d).bfloat16(),
            group(dk * args[1]).bfloat16(), group(dv).bfloat16())


#: (b, h, kvh, sq, sk, causal, window, kv_lengths, q_start, k_start): a
#: chunk of 160 queries at 4096 over 300 keys at 4150, whose first 54
#: rows see no key, a window's edge and the diagonal crossing it and a
#: global length ending inside it; a past chunk under GQA that a window
#: cuts
OFFSET_CASES = {
    "straddling_window_kv_lengths": (2, 2, 2, 160, 300, True, 100,
                                     [4200, 4500], 4096, 4150),
    "past_chunk_gqa_window": (1, 4, 2, 128, 192, True, 200, None, 4224,
                              4032),
}


def _offset_inputs(name, seed=5):
    b, h, kvh, sq, sk, causal, window, kvl, q_start, k_start = \
        OFFSET_CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .bfloat16() for shape in ((b, h, sq, 64), (b, kvh, sk, 64),
                                             (b, kvh, sk, 64),
                                             (b, h, sq, 64)))
    kvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    return q, k, v, do, (kvl, 0.125, causal, window, q_start, k_start)


@pytest.mark.parametrize("name", list(OFFSET_CASES))
def test_kernel_b_rounding_plan_at_offsets_holds_one_ulp(name):
    """Kernel B's bf16 plan at global offsets keeps o within one bf16 ulp
    of the plain chunk version and lse within 1e-4; rows that see no key
    of the chunk are 0 with lse 1e30."""
    q, k, v, _, args = _offset_inputs(name)
    want_o, want_lse = flash_chunk_fwd_plain(q, k, v, *args)
    got_o, got_lse = _kernel_b_emulation(q, k, v, args)
    _check("o", want_o, got_o, torch.bfloat16)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-6)
    empty = want_lse == 1e30
    assert bool(empty.any()) == name.startswith("straddling")
    assert bool((got_lse[empty] == 1e30).all())
    assert not got_o[empty].any()


@pytest.mark.parametrize("name", list(OFFSET_CASES))
def test_kernel_i_rounding_plan_with_given_delta_holds_one_ulp(name):
    """Kernel I's bf16 plan at global offsets, on a given delta (not
    rowsum(do * o) of the chunk's own o: the global one, here o of
    another chunk set), keeps dq, dk and dv within 1 bf16 ulp of the
    plain chunk version plus the rounding slack, at most 0.1% of the
    elements past 1 ulp."""
    q, k, v, do, args = _offset_inputs(name)
    o, lse = flash_chunk_fwd_plain(q, k, v, *args)
    delta = (do.float() * o.float()).sum(-1) * 0.5 + 0.25
    want = flash_chunk_bwd_plain(q, k, v, do, lse, delta, *args)
    slack = flash_bwd_rounding_slack(q, k, v, do, None, lse, *args,
                                     delta=delta)
    got = _kernel_i_emulation(q, k, v, do, lse, delta, args)
    for n, w, g, sl in zip(("dq", "dk", "dv"), want, got, slack):
        _check(n, w, g, torch.bfloat16, sl, max_past_ulp=1e-3)
