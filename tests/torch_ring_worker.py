"""One rank of the gloo ring that ``tests/test_torch_ring_attention.py``
spawns (not a test module: it imports neither JAX nor the JAX package).

:func:`run` joins a ``world``-rank gloo group through a ``FileStore``,
runs :func:`apex_tpu_torch.ops.ring_attention` forward and backward on its
chunk of every case in ``inputs`` (a ``torch.save`` file of ``(q, k, v,
do, kwargs)`` over the whole sequence), checks that a group of size 1
gives :func:`flash_attention` bit for bit, and saves ``(o, dq, dk, dv)``
of each case to ``out``.
"""

import datetime

import torch
import torch.distributed as dist

from apex_tpu_torch.ops import flash_attention
from apex_tpu_torch.ops.ring_attention import ring_attention


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        results = []
        for q, k, v, do, kw in torch.load(inputs):
            qc, kc, vc = (t.chunk(world, dim=2)[rank].clone()
                          .requires_grad_() for t in (q, k, v))
            o = ring_attention(qc, kc, vc, group=dist.group.WORLD, **kw)
            o.backward(do.chunk(world, dim=2)[rank])
            results.append((o.detach(), qc.grad, kc.grad, vc.grad))
        own, _ = dist.new_subgroups(group_size=1)
        alone = ring_attention(qc, kc, vc, group=own, **kw)
        size1_is_flash = torch.equal(alone, flash_attention(qc, kc, vc, **kw))
        torch.save({"results": results, "size1_is_flash": size1_is_flash},
                   out)
    finally:
        dist.destroy_process_group()
