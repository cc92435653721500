"""The port stands alone: every module of `distributed_neural_network_tpu_torch`
(the pipeline's `parallel/pipeline.py`, the checkpoints' and the tracing's
among them) and the probes of
`port_probes/` import with `jax`, `flax` and the JAX package blocked, and no
source line of the port, of `chip_smoke.py` or of a probe imports them."""

import os
import pkgutil
import re
import subprocess
import sys

import distributed_neural_network_tpu_torch as port

PKG_DIR = os.path.dirname(port.__file__)
ROOT = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix=port.__name__ + ".")
    )


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "distributed_neural_network_tpu_torch.ops.fused_head" in mods
    # the data axis's modules
    for m in ("parallel.rules", "parallel.zero", "parallel.partition", "parallel.collectives",
              "parallel.pipeline", "parallel.moe", "utils.tree",
              # checkpoints, tracing, the goodput record, preemption
              "utils.checkpoint", "utils.tracing", "utils.goodput", "train.guard",
              "parallel.reshard", "train.elastic",
              # the monitor
              "train.monitor", "utils.obs",
              # the elastic supervisor and its launcher
              "train.supervisor", "launch"):
        assert f"distributed_neural_network_tpu_torch.{m}" in mods
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'distributed_neural_network_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|distributed_neural_network_tpu)(\b(?!_torch)|\.)"
    )
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for i, line in enumerate(open(path), 1):
                    if pattern.search(line):
                        offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert not [l for l in f if pattern.search(l)]


PROBES = os.path.join(ROOT, "port_probes")


def test_probes_import_with_jax_blocked_and_name_no_jax():
    """`port_probes/pp_world.py` and `remat_policies.py` (chip_smoke.py phases
    26-27 and the four-card pipeline run), like every probe, import with
    the JAX package blocked, and no line of theirs imports it."""
    probes = sorted(f[:-3] for f in os.listdir(PROBES) if f.endswith(".py"))
    assert "pp_world" in probes and "remat_policies" in probes and "ckpt_world" in probes
    assert "supervisor_world" in probes
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'distributed_neural_network_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path[:0] = [{ROOT!r}, {PROBES!r}, {os.path.join(ROOT, 'tests')!r}]\n"
        "import importlib\n"
        f"for m in {probes!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|distributed_neural_network_tpu)(\b(?!_torch)|\.)"
    )
    for name in probes:
        with open(os.path.join(PROBES, name + ".py")) as f:
            assert not [line for line in f if pattern.search(line)], name
