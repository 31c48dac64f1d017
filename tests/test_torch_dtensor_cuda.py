"""The sharded paths on the card (marker ``cuda``; each case skips with a
reason where CUDA is not available):

* the two kernels of the dense path (``rmsnorm`` through
  ``layers.rms_norm``, ``flash_attention`` through
  ``attention.attn_train`` under ``use_pallas``) on DTensors of a
  (1, 1) mesh of a 1-rank NCCL group launch their kernels once each and
  equal the plain-tensor call;
* the ``sharded`` cohort backend over two cards equals ``vmap``.

    python -m pytest -q -m cuda tests/test_torch_dtensor_cuda.py

The CPU side of both (specs, the 4-rank gloo SPMD step, CPU meshes) is in
``tests/test_torch_sharding.py`` and ``tests/test_torch_sharded_backend.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.models import get_api
from repro_torch.sharding import partition as part
from repro_torch.tree import tree_leaves


@pytest.fixture
def nccl_mesh(tmp_path):
    """A (1, 1) ('data', 'model') mesh of a 1-rank NCCL group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield make_test_mesh((1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_kernels_on_dtensors_launch_once(nccl_mesh):
    """``rms_norm`` and flash on DTensors of a 1-rank NCCL mesh launch
    their kernels once each and equal the plain-tensor call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import attention
    from repro_torch.models.layers import rms_norm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 128, 256, generator=gen, device="cuda")
    w = torch.rand(256, generator=gen, device="cuda") + 0.5
    with torch.no_grad():
        want = rms_norm(x, w)
        reset_launches()
        got = rms_norm(distribute_tensor(x, nccl_mesh, [Shard(0), Shard(2)]),
                       distribute_tensor(w, nccl_mesh, [Replicate(), Replicate()]))
    assert isinstance(got, DTensor) and dict(LAUNCHES) == {"rmsnorm": 1}
    torch.testing.assert_close(got.full_tensor(), want, atol=0, rtol=0)

    cfg = smoke_config("qwen3-0.6b").replace(use_pallas=True)
    params = get_api(cfg).init_params(prng.PRNGKey(0, device="cuda"), cfg, device="cuda")
    p = {k: v[0] for k, v in params["dense_layers"]["attn"].items()}
    h = torch.randn(2, 128, cfg.d_model, generator=gen, device="cuda")
    pos = torch.arange(128, device="cuda").expand(2, 128)
    with torch.no_grad():
        want = attention.attn_train(p, cfg, h, pos)
        dp = {k: distribute_tensor(v, nccl_mesh, [Replicate(), Replicate()]) for k, v in p.items()}
        with part.use_mesh(nccl_mesh):
            reset_launches()
            got = attention.attn_train(dp, cfg, distribute_tensor(h, nccl_mesh, [Shard(0),
                                                                                  Replicate()]),
                                       pos)
            launches = dict(LAUNCHES)
    assert launches.get("flash_attention") == 1, launches
    torch.testing.assert_close(got.full_tensor(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_sharded_backend_over_two_cards():
    """The ``sharded`` backend over two cards: a 10-client cohort split 5/5
    equals ``vmap`` within 1e-6, gathered on the primary card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards; this host has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from repro_torch.api.backend import CohortTask, ShardedBackend, VmapBackend
    from repro_torch.fed import standard_tasks
    from repro_torch.fed.trainer import (fed_client_batch, fed_local_fn, init_task_models,
                                         task_round_key)

    task = standard_tasks(["synth-mnist"], n_clients=10, seed=0, n_range=(40, 60))[0]
    params = init_task_models([task], prng.PRNGKey(0), 64, 2, device="cuda")[0]
    batch = fed_client_batch(task, task_round_key(0, 0, 0), np.arange(10), device="cuda")
    job = CohortTask("t", params, fed_local_fn(3, 0.1, 32))
    want = VmapBackend(device="cuda").run_cohort(job, batch)
    got = ShardedBackend(device="cuda", mesh=("cuda:0", "cuda:1")).run_cohort(job, batch)
    for a, b in zip(tree_leaves(want.updates), tree_leaves(got.updates)):
        assert b.device == a.device
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
