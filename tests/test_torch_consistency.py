"""Replica consistency and the process world's helpers across ranks.

JAX compares the addressable shards of an array that cover the same index
range (its ``tests/test_consistency.py`` on 8 virtual devices); the port
compares each tensor's digest across the ranks of a gloo world (worlds of
2, 3 and 4 spawned processes, ``test_torch_cp_workers.py``). The same
healthy and diverged trees go through both, and both must name the same
leaves; the callbacks raise alike. Exact (digests, names, float64 means).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chronoedit_tpu.parallel.consistency import check_replica_consistency as check_j
from chronoedit_tpu_torch.parallel import consistency, distributed
from chronoedit_tpu_torch.parallel.launch import run_world
import test_torch_cp_workers as W

TIMEOUT = 120.0


def world(tmp_path, fn, n, *args):
    return run_world(fn, n, args, timeout=TIMEOUT, tmp_dir=str(tmp_path))


def jax_tree(diverge: int | None):
    """W.consistency's tree, replicated over JAX's 8 devices, with device
    ``diverge``'s ``w`` off by 1e-6 where the port's rank is."""
    import torch

    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 3, generator=g).numpy()
    lin = torch.randn(2, 3, generator=g).numpy()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "tensor"))
    devs = list(mesh.devices.flat)

    def replicated(per_device):
        bufs = [jax.device_put(per_device(i), d) for i, d in enumerate(devs)]
        a = per_device(0)
        return jax.make_array_from_single_device_arrays(a.shape, NamedSharding(mesh, P()), bufs)

    def w_on(i):
        a = w.copy()
        if i == diverge:
            a[1, 2] += 1e-6
        return a

    return {"w": replicated(w_on), "ok": [jnp.ones(2), jnp.arange(5)],
            "module": {"weight": replicated(lambda i: lin), "bias": jnp.zeros(2)}}


@pytest.mark.parametrize("n,diverge", [(2, None), (4, 3), (2, 0)])
def test_replicas_across_ranks_match_jax(tmp_path, n, diverge):
    """Healthy: no rank names a tensor and the callback passes silently;
    one rank off by 1e-6 in one element: every rank names ``w`` (as JAX
    names the leaf one device of which disagrees) and the callback raises
    on every rank."""
    got = world(tmp_path, W.consistency, n, diverge)
    want = check_j(jax_tree(diverge))
    for rank, res in enumerate(got):
        assert res["bad"] == want == ([] if diverge is None else ["w"])
        if diverge is None:
            assert res["raised"] is None
            assert res["digest"] == got[0]["digest"]
        else:
            assert "replica divergence" in res["raised"] and "'w'" in res["raised"]
            same_side = (rank == diverge) == (diverge == 0)
            assert (res["digest"] == got[0]["digest"]) == same_side


def test_one_process_has_no_replicas():
    """Without a world no replica can disagree."""
    import torch

    assert consistency.check_replica_consistency({"w": torch.ones(3)}) == []
    assert check_j({"w": jnp.ones(3)}) == []


def test_collate_metrics_across_ranks(tmp_path):
    """``collate_metrics`` gives every rank the cross-rank means (JAX's
    ``np.mean`` of the gathered values), ``process_count`` / ``index`` /
    ``is_primary`` / ``local_batch_size`` read the world."""
    got = world(tmp_path, W.collate, 3)
    for rank, res in enumerate(got):
        assert res["metrics"] == {"loss": float(np.mean([1.0, 2.0, 3.0])),
                                  "acc": float(np.mean([0.0, 0.5, 1.0]))}
        assert (res["count"], res["index"], res["primary"]) == (3, rank, rank == 0)
        assert res["local_batch"] == 2
        assert "not divisible by 3 processes" in res["indivisible"]


def test_init_distributed_needs_a_launcher(monkeypatch):
    """Without a launcher's rendezvous (``MASTER_ADDR``) one process is a
    no-op and a larger ``WORLD_SIZE`` raises rather than wait."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="torchrun"):
        distributed.init_distributed()
