"""The port's dry-run (``repro_torch.launch.dryrun``, ``op_analysis``) on
a fake process group of 256 ranks, on meta tensors.

* Every arch x shape builds ``ok`` at its smoke config on the 16 x 16
  production mesh, and every tensor it makes off the host is a meta
  tensor (on the host, DTensor's integer shard arithmetic only). zamba2's
  smoke config keeps the family's full-size SSM chunk of 256: its smoke
  chunk of 8 makes 4,096 chunk steps a layer at ``prefill_32k``.
* Its per-device flops: on a (1, 1) mesh equal to
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same plain
  step (the kernels booked by their own formulas, a loop traced once on
  meta tensors booked by its trip count, as ``op_analysis`` books them),
  with no collective; on 16 x 16 between that count / 256 and the count.
* Its params (all, and active per token) and model flops per device equal
  the JAX package's (``jax.eval_shape`` and ``active_param_count`` at its
  ``tuned_config``) for every full-size arch x shape x mesh.
* The command line writes its record.

A default process group is never set in a test worker: the dry-runs run
in a subprocess (this file, run as a script), and the JAX side in another
with ``JAX_PLATFORMS=cpu``, because importing ``repro.launch.dryrun`` sets
the 512-device ``XLA_FLAGS``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-135m", "qwen1.5-0.5b", "qwen3-0.6b", "phi-3-vision-4.2b", "whisper-medium",
         "xlstm-1.3b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-7b", "qwen1.5-110b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = (("single", 256), ("multi", 512))

JAX_PROG = """
import json, sys
from repro.launch.dryrun import tuned_config
import jax
from repro.models import get_api
from repro.models.model import active_param_count
out = {}
for arch in sys.argv[2].split(","):
    for shape in sys.argv[3].split(","):
        cfg, sh = tuned_config(arch, shape)
        p = jax.eval_shape(lambda k: get_api(cfg).init_params(k, cfg), jax.random.key(0))
        n_active = int(active_param_count(p, cfg))
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        factor = 6 if sh.kind == "train" else 2
        for mesh, n in ((m.split(":")[0], int(m.split(":")[1])) for m in sys.argv[4].split(",")):
            out[f"{arch}|{shape}|{mesh}"] = [int(sum(x.size for x in jax.tree.leaves(p))),
                                             n_active, factor * n_active * tokens / n]
json.dump(out, open(sys.argv[1], "w"))
"""


def smoke(arch):
    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch)
    return cfg.replace(ssm_chunk=256) if cfg.ssm_state else cfg


def run(out_path):
    """The dry-runs of the tests, in this process: a fake group of 256."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import trips
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    class TripsFlopCounter(FlopCounterMode):
        """``FlopCounterMode`` that books a traced loop by its trip count."""

        def _count_flops(self, func_packet, out, args, kwargs):
            before = self.get_total_flops()
            out = super()._count_flops(func_packet, out, args, kwargs)
            extra = (self.get_total_flops() - before) * (trips.factor() - 1)
            if extra:
                for par in set(self.mod_tracker.parents):
                    self.flop_counts[par][func_packet] += extra
            return out

    torch.set_num_threads(1)
    dryrun.fake_group(256)
    one = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
    res = {"costs": {}, "smoke": {}}
    for arch in ARCHS:
        for shape in SHAPES:
            cfg, sh = dryrun.tuned_config(arch, shape)
            for mesh, n in MESHES:
                res["costs"][f"{arch}|{shape}|{mesh}"] = list(
                    dryrun.model_costs(cfg, sh, n).values())
            base = smoke(arch)
            fn, args, _ = dryrun.build_step(dryrun.tuned_config(arch, shape, base=base)[0],
                                            INPUT_SHAPES[shape], None)
            with TripsFlopCounter(display=False) as fc:
                fn(*args)
            r = dryrun.run_dryrun(arch, shape, base=base)
            got = {"plain_flops": fc.get_total_flops(),
                   "loop": r.get("memory", {}).get("loop_traced_once"),
                   **{k: r.get(k) for k in ("ok", "error", "flops", "devices", "host_bytes_max",
                                            "kernels")}}
            if shape == "train_4k":
                r1 = dryrun.run_dryrun(arch, shape, base=base, mesh=one)
                got.update(one_ok=r1["ok"], one_flops=r1.get("flops"),
                           one_collectives=r1.get("collectives"), one_error=r1.get("error"))
            res["smoke"][f"{arch}|{shape}"] = got
    Path(out_path).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    meshes = ",".join(f"{m}:{n}" for m, n in MESHES)
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_PROG, str(tmp / "jax.json"),
                                 ",".join(ARCHS), ",".join(SHAPES), meshes],
                                env=env, cwd=ROOT, stderr=subprocess.PIPE, text=True)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(tmp / "port.json")],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    _, jax_err = jax_proc.communicate(timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert jax_proc.returncode == 0, jax_err[-6000:]
    res = json.loads((tmp / "port.json").read_text())
    res["jax"] = json.loads((tmp / "jax.json").read_text())
    return res


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_and_shape_builds_on_the_production_mesh(results, arch, shape):
    """``ok`` at the smoke config on the fake 16 x 16 mesh, with only meta
    tensors made off the host, and no floating-point one over 1 KiB on
    the host (DTensor's shard arithmetic makes integer ones there)."""
    r = results["smoke"][f"{arch}|{shape}"]
    assert r["ok"], r["error"]
    assert r["devices"] == ["meta"] and r["host_bytes_max"] <= 1024, r


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device_between_the_plain_count_and_its_share(results, arch, shape):
    """On 16 x 16 each device does no more than the whole plain step and no
    less than a 256th of it."""
    r = results["smoke"][f"{arch}|{shape}"]
    assert r["plain_flops"] / 256 <= r["flops"] <= r["plain_flops"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_on_one_device_equal_the_flop_counter(results, arch):
    """A training step on a (1, 1) mesh books the plain step's flops
    exactly, and no collective."""
    r = results["smoke"][f"{arch}|train_4k"]
    assert r["one_ok"], r["one_error"]
    assert r["one_flops"] == r["plain_flops"] > 0
    assert r["one_collectives"]["total_bytes"] == 0 and not r["one_collectives"]["count_by_op"]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_loop_traced_once_is_named_in_the_record(results, arch):
    """``memory.loop_traced_once`` is the trip count of a loop over time
    traced once (the sLSTM's, over the sequence of a training step or a
    prefill), whose peak holds one trip's intermediates; 0 elsewhere."""
    from repro_torch.configs import INPUT_SHAPES

    for shape in SHAPES:
        sh = INPUT_SHAPES[shape]
        want = sh.seq_len if arch == "xlstm-1.3b" and sh.kind != "decode" else 0
        assert results["smoke"][f"{arch}|{shape}"]["loop"] == want, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_model_flops_equal_the_reference(results, arch):
    """params_total, params_active and model_flops_per_device equal the
    JAX package's for every shape and mesh at full size."""
    for shape in SHAPES:
        for mesh, _ in MESHES:
            key = f"{arch}|{shape}|{mesh}"
            total, active, flops = results["costs"][key]
            jtotal, jactive, jflops = results["jax"][key]
            assert (total, active) == (jtotal, jactive), key
            assert flops == pytest.approx(jflops, rel=1e-12), key


def test_command_line_writes_the_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at full size, on a machine
    without CUDA: the record with its keys, ``ok``, on meta tensors only."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "smollm-135m", "--shape", "long_500k", "--out", str(out)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(out.read_text())
    for key in ("ok", "mesh", "n_devices", "lower_s", "memory", "flops", "bytes", "collectives",
                "roofline", "params_total", "params_active", "model_flops_per_device",
                "useful_flop_ratio"):
        assert key in rec, key
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["devices"] == ["meta"] and rec["host_bytes_max"] <= 1024
    assert rec["memory"]["fits"] and rec["memory"]["loop_traced_once"] == 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")


if __name__ == "__main__":
    run(sys.argv[1])
