"""The port's checkpoint format against the JAX package's, on the CPU.

- Byte-identical step directories: one tree (nested dicts, a list, a
  ``LossScalerState``, f32/f16/bf16/int32/int8/bool leaves, 0-dim
  leaves) saved by both packages' ``ShardedCheckpointManager`` at one
  step gives the same file names and the same bytes in every ``.npy``,
  ``manifest.json`` and ``COMMIT``.
- The port restores the JAX package's directories bitwise, bf16 included
  (the JAX package writes bf16 but cannot read it back: see ROADMAP §3),
  and a step the JAX package wrote over the 8-device CPU mesh (dp=4 x
  tp=2 leaves, several shards a leaf) restores whole.
- The verifiers agree: each package's ``verify_directory`` reads the
  other's directories as ``ok``; each kind of damage (``corrupt_shard``
  bitflip / truncate / missing, ``tear_manifest``, uncommitted debris)
  gives the same statuses and problem strings from both, and both CLIs
  the same exit codes (``--shallow`` misses a bitflip and catches a
  truncation; ``--gc`` removes only debris).
- Port-only: pruning and the commit protocol; an async save returns
  before it commits, and drain / abandon behave as JAX's; failed attempts
  sweep their debris and a restore never adopts a partial step; an
  in-place update after ``snapshot`` does not change what is written; a
  corrupt step leaves the template untouched; the whole-state
  (``torch.save``) manager's round trip and its debris.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from apex_tpu import checkpoint as jck
from apex_tpu import testing_faults as jfaults
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.checkpoint import verify as jverify
from apex_tpu_torch import checkpoint as tck
from apex_tpu_torch import testing_faults as tfaults
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.checkpoint import sharded as tsharded
from apex_tpu_torch.checkpoint import verify as tverify
from apex_tpu_torch.checkpoint import whole

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "w": rs.randn(3, 5).astype(np.float32),
        "h": rs.randn(4).astype(np.float16),
        "b16": rs.randn(2, 3).astype(np.float32),   # stored as bf16
        "i32": rs.randint(-50, 50, (5,)).astype(np.int32),
        "i8": rs.randint(-5, 5, (2, 2)).astype(np.int8),
        "bool": rs.rand(3) > 0.5,
        "s": np.float32(rs.randn()),
    }


def _jax_tree(a):
    return {"a": {"w": jnp.asarray(a["w"]), "h": jnp.asarray(a["h"]),
                  "b16": jnp.asarray(a["b16"], jnp.bfloat16)},
            "l": [jnp.asarray(a["i32"]), jnp.asarray(a["i8"]),
                  jnp.asarray(a["bool"])],
            "scaler": JaxLossScaler("dynamic", hysteresis=2).init(),
            "s": jnp.asarray(a["s"])}


def _torch_tree(a):
    return {"a": {"w": torch.from_numpy(a["w"].copy()),
                  "h": torch.from_numpy(a["h"].copy()),
                  "b16": torch.from_numpy(a["b16"]).to(torch.bfloat16)},
            "l": [torch.from_numpy(a["i32"].copy()),
                  torch.from_numpy(a["i8"].copy()),
                  torch.from_numpy(a["bool"].copy())],
            "scaler": LossScaler("dynamic", hysteresis=2).init("cpu"),
            "s": torch.tensor(a["s"])}


def _zeros_like(tree):
    return {
        "a": {k: torch.zeros_like(v) for k, v in tree["a"].items()},
        "l": [torch.zeros_like(v) for v in tree["l"]],
        "scaler": LossScaler("dynamic", init_scale=1.0).init("cpu"),
        "s": torch.zeros_like(tree["s"])}


def _equal_trees(a, b):
    for (ka, va), (kb, vb) in zip(tsharded.tree_items(a),
                                  tsharded.tree_items(b)):
        assert ka == kb
        assert va.dtype == vb.dtype and torch.equal(va, vb), ka


def _save_both(tmp_path, step=7):
    a = _arrays()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.ShardedCheckpointManager(jd, fsync=False).save(step, _jax_tree(a),
                                                       force=True)
    tck.ShardedCheckpointManager(td, fsync=False).save(step, _torch_tree(a),
                                                       force=True)
    return jd, td, a


def test_step_directories_are_byte_identical(tmp_path):
    jd, td, _ = _save_both(tmp_path)
    names = sorted(os.listdir(os.path.join(jd, "7")))
    assert names == sorted(os.listdir(os.path.join(td, "7")))
    assert {"manifest.json", "COMMIT"} < set(names)
    assert sum(n.endswith(".npy") for n in names) == 11
    for name in names:
        with open(os.path.join(jd, "7", name), "rb") as f:
            want = f.read()
        with open(os.path.join(td, "7", name), "rb") as f:
            assert f.read() == want, name


def test_port_restores_jax_steps_bitwise_bf16_included(tmp_path):
    jd, _, a = _save_both(tmp_path)
    with pytest.raises(ValueError):     # the JAX package cannot read bf16
        jck.ShardedCheckpointManager(jd).restore_step(7, _jax_tree(a))
    want = _torch_tree(a)
    template = _zeros_like(want)
    got = tck.ShardedCheckpointManager(jd).restore_step(7, template)
    assert got is template
    _equal_trees(got, want)


def test_port_restores_a_jax_mesh_step_whole(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "tensor"))
    rs = np.random.RandomState(1)
    arrays = {"dt": rs.randn(8, 6).astype(np.float32),
              "t": rs.randn(5, 4).astype(np.float32),
              "d": rs.randint(0, 9, (12,)).astype(np.int32),
              "rep": rs.randn(3).astype(np.float32),
              "b16": rs.randn(4, 10).astype(np.float32)}
    specs = {"dt": PartitionSpec("data", "tensor"),
             "t": PartitionSpec(None, "tensor"), "d": PartitionSpec("data"),
             "rep": PartitionSpec(), "b16": PartitionSpec("data", "tensor")}
    tree = {k: jax.device_put(
        jnp.asarray(v, jnp.bfloat16 if k == "b16" else None),
        NamedSharding(mesh, specs[k])) for k, v in arrays.items()}
    d = str(tmp_path / "mesh")
    jck.ShardedCheckpointManager(d, fsync=False).save(3, tree, force=True)
    leaves = jck.manifest.load_manifest(os.path.join(d, "3"))["leaves"]
    assert len(leaves["['dt']"]["shards"]) == 8
    assert len(leaves["['rep']"]["shards"]) == 1
    template = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if k == "b16"
                               else torch.from_numpy(v).dtype)
                for k, v in arrays.items()}
    tck.ShardedCheckpointManager(d).restore_step(3, template)
    for k, v in arrays.items():
        want = torch.from_numpy(v)
        if k == "b16":
            want = want.to(torch.bfloat16)
        assert torch.equal(template[k], want), k


DAMAGE = {
    "bitflip": lambda f, d: f.corrupt_shard(d, 7, leaf=3, kind="bitflip"),
    "truncate": lambda f, d: f.corrupt_shard(d, 7, leaf=1, kind="truncate"),
    "missing": lambda f, d: f.corrupt_shard(d, 7, leaf=5, kind="missing"),
    "torn_manifest": lambda f, d: f.tear_manifest(d, 7),
    "debris": lambda f, d: os.makedirs(os.path.join(d, "9")),
}


def _reports(mod, root, deep=True):
    return [(r.step, r.status, [p.replace(root, "<root>")
                                for p in r.problems])
            for r in mod.verify_directory(root, deep=deep)]


@pytest.mark.parametrize("kind", ["clean"] + list(DAMAGE))
def test_verifiers_and_clis_agree_on_damage(tmp_path, kind, capsys):
    jd, td, _ = _save_both(tmp_path)
    if kind != "clean":
        DAMAGE[kind](jfaults, jd)
        DAMAGE[kind](tfaults, td)
    seen = set()
    for root in (jd, td):
        want = _reports(jverify, root)
        assert _reports(tverify, root) == want
        seen.add(repr(want))
        for flags in ([], ["--shallow"]):
            assert tverify.main(["verify", root, *flags]) == \
                jverify.main(["verify", root, *flags]), flags
    assert len(seen) == 1        # the same story from either writer's dir
    status = {s for _, s, _ in _reports(tverify, td)}
    if kind == "clean":
        assert status == {"ok"}
    elif kind == "debris":
        assert status == {"ok", "uncommitted"}
    else:
        assert status == {"damaged"}
    shallow = tverify.main(["verify", td, "--shallow"])
    assert shallow == (1 if kind in ("truncate", "missing",
                                     "torn_manifest") else 0)
    capsys.readouterr()


def test_gc_removes_only_debris(tmp_path, capsys):
    jd, td, _ = _save_both(tmp_path)
    for root, faults, mod in ((jd, jfaults, jverify), (td, tfaults, tverify)):
        os.makedirs(os.path.join(root, "9"))
        assert mod.main(["verify", root, "--gc"]) == 0
        assert sorted(os.listdir(root)) == ["7"]
    out = capsys.readouterr().out
    assert out.count("gc: removed uncommitted step 9") == 2


def test_cli_module_entry_point(tmp_path):
    _, td, _ = _save_both(tmp_path)
    tfaults.corrupt_shard(td, 7, leaf=0, kind="bitflip")
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.checkpoint", "verify", td],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "DAMAGED steps:   [7]" in out.stdout
    assert "sha256 mismatch" in out.stdout


def _mgr(root, **kw):
    return tck.ShardedCheckpointManager(str(root), fsync=False, **kw)


def _state(v):
    return {"w": torch.full((4, 3), float(v)),
            "b16": torch.full((5,), float(v), dtype=torch.bfloat16),
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_pruning_and_commit_protocol(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, max_to_keep=2, save_interval_steps=2)
    assert mgr.save(3, _state(3)) is False          # gated
    for s in (2, 4, 6):
        assert mgr.save(s, _state(s))
    assert mgr.all_steps() == [4, 6]
    with pytest.raises(FileExistsError):
        mgr.save(6, _state(6))

    # a writer killed mid-step leaves a directory without COMMIT: invisible
    real = tsharded.npy_bytes
    calls = {"n": 0}

    def dying(arr, name):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("killed")
        return real(arr, name)

    monkeypatch.setattr(tsharded, "npy_bytes", dying)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(8, _state(8))
    monkeypatch.setattr(tsharded, "npy_bytes", real)
    assert mgr.all_steps() == [4, 6] and mgr.uncommitted_steps() == [8]
    assert mgr.latest_step() == 6
    assert mgr.cleanup_partial() == [8]
    assert mgr.uncommitted_steps() == []
    mgr.verify_step(6)


def _delayed_async(pkg, faults, root, tree):
    inj = faults.FaultInjector(save_delays={4: 1.5})
    base = pkg.ShardedCheckpointManager(str(root), fsync=False)
    mgr = pkg.RetryingCheckpointManager(base, backoff_base=0.0,
                                        before_save=inj.before_checkpoint_save)
    t0 = time.monotonic()
    assert mgr.save(4, tree)
    returned = time.monotonic() - t0
    early = base.all_steps()
    assert mgr.save(8, tree)
    pending = mgr.pending_saves
    mgr.drain(abandon=True)
    out = (returned, early, pending, base.all_steps(), dict(mgr.telemetry))
    mgr.close()
    return out


def test_async_save_returns_before_commit_and_abandon_like_jax(tmp_path):
    a = _arrays()
    j = _delayed_async(jck, jfaults, tmp_path / "j", _jax_tree(a))
    t = _delayed_async(tck, tfaults, tmp_path / "t", _torch_tree(a))
    assert t[0] < 1.0 and t[1] == []                # returned before commit
    assert t[2] == [4, 8] and t[3] == [4]           # 8 abandoned in queue
    assert t[4]["saves_abandoned"] == 1
    assert t[1:] == j[1:]


def test_failed_attempt_sweeps_debris_and_restore_skips_partials(tmp_path):
    base = _mgr(tmp_path)
    real = base.write_snapshot
    calls = {"n": 0}

    def flaky(step, snap, force=False):
        calls["n"] += 1
        if calls["n"] == 1:               # half a step on disk, then fail
            os.makedirs(base._step_dir(step))
            with open(os.path.join(base._step_dir(step), "leaf0000_s00.npy"),
                      "wb") as f:
                f.write(b"half")
            raise IOError("disk hiccup")
        return real(step, snap, force=force)

    base.write_snapshot = flaky
    mgr = tck.RetryingCheckpointManager(base, backoff_base=0.0,
                                        async_writes=False)
    assert mgr.save(4, _state(4))
    assert mgr.telemetry["save_retries"] == 1
    assert mgr.telemetry["partials_cleaned"] == 1
    assert base.all_steps() == [4]
    os.makedirs(base._step_dir(9))            # debris newer than any step
    template = _state(0)
    step, got = mgr.restore_latest(template)
    assert step == 4 and got is template
    _equal_trees(template, _state(4))
    assert mgr.telemetry["partials_cleaned"] == 2
    assert base.uncommitted_steps() == []


def test_snapshot_is_not_moved_by_in_place_updates(tmp_path):
    mgr = _mgr(tmp_path)
    live = _state(1)
    snap = mgr.snapshot(live)
    for t in live.values():
        t.add_(5)                              # the optimizer's in-place step
    mgr.write_snapshot(1, snap)
    template = _state(0)
    mgr.restore_step(1, template)
    _equal_trees(template, _state(1))


def test_corrupt_step_leaves_the_template_untouched(tmp_path):
    base = _mgr(tmp_path)
    base.save(4, _state(4))
    base.save(8, _state(8))
    # damage the LAST leaf, so earlier leaves would be written first by a
    # restore that did not verify the whole step before writing
    tfaults.corrupt_shard(str(tmp_path), 8, leaf=2, kind="bitflip")
    live = _state(3)
    with pytest.raises(tck.CheckpointCorruptionError, match="sha256"):
        base.restore_step(8, live)
    _equal_trees(live, _state(3))
    mgr = tck.RetryingCheckpointManager(base)
    step, _ = mgr.restore_latest(live)
    assert step == 4
    _equal_trees(live, _state(4))
    assert mgr.telemetry["verify_failures"] == 1
    assert mgr.telemetry["deleted_corrupt"] == 1
    assert base.all_steps() == [4]


def test_corrupt_checkpoint_weights_passes_verification(tmp_path):
    base = _mgr(tmp_path)
    base.save(4, _state(4))
    assert tfaults.corrupt_checkpoint_weights(str(tmp_path), 4) == 2
    base.verify_step(4)
    template = _state(0)
    base.restore_step(4, template)
    assert torch.isnan(template["w"]).all()
    assert torch.isnan(template["b16"]).all()
    assert int(template["step"]) == 4


def test_whole_state_manager_round_trip_and_debris(tmp_path):
    mgr = whole.CheckpointManager(str(tmp_path / "w"), max_to_keep=2)
    for s in (1, 2, 3):
        assert mgr.save(s, _state(s))
    assert mgr.all_steps() == [2, 3]
    live = _state(0)
    step, got = mgr.restore(live)
    assert step == 3 and got is live
    _equal_trees(live, _state(3))
    os.makedirs(os.path.join(mgr.directory, "4.orbax-checkpoint-tmp-1"))
    assert mgr.uncommitted_steps() == [4] and mgr.all_steps() == [2, 3]
    assert mgr.cleanup_partial() == [4]
    assert tfaults.corrupt_checkpoint(mgr.directory, 3) == 1
    retry = tck.RetryingCheckpointManager(mgr)
    step, _ = retry.restore_latest(live)
    assert step == 2
    _equal_trees(live, _state(2))
    assert retry.telemetry["restore_fallbacks"] == 1
    assert retry.telemetry["verify_failures"] == 0
    path = str(tmp_path / "one")
    tck.save_checkpoint(path, _state(7))
    loaded = tck.load_checkpoint(path)
    assert torch.equal(loaded["['w']"], _state(7)["w"])
    with pytest.raises(FileExistsError):
        tck.save_checkpoint(path, _state(7), force=False)
    live = _state(0)
    assert tck.load_checkpoint(path, live) is live
    _equal_trees(live, _state(7))


def test_incident_counts_survive_concurrent_writers(tmp_path):
    """The writer thread and the caller count incidents at once: more
    threads than cores, a short switch interval, and no lost update."""
    import threading

    mgr = tck.RetryingCheckpointManager(_mgr(tmp_path))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [mgr._tick("save_attempts") for _ in range(2000)])
            for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert mgr.telemetry["save_attempts"] == 2000 * len(threads)
