"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole, since vil_fusion_tpu_torch begins with
vil_fusion_tpu), and the reference loads nothing of the port."""
import subprocess
import sys

from vilbench.tests.tiny import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
import importlib, glob, os
for mod in {mods!r}:
    importlib.import_module(mod)
for kind in ("end_to_end", "layer_metrics"):
    for path in glob.glob(os.path.join({root!r}, "vilbench", kind, "*.py")):
        from vilbench import harness
        harness.reader({root!r}, kind, os.path.basename(path)[:-3])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(mods):
    code = PROBE.format(root=ROOT, mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _top_level(["vilbench.harness", "vilbench.trace", "vilbench.traffic.circuit",
                      "vilbench.reference.vil", "vilbench.reference.lidar", "vilbench.sim.sim",
                      "vil_fusion_tpu_torch.runtime.pipeline"])
    assert not top & {"jax", "jaxlib", "flax", "vil_fusion_tpu"}
    assert "vil_fusion_tpu_torch" in top  # the system under test


def test_reference_loads_nothing_of_the_port():
    top = _top_level(["vilbench.reference.common", "vilbench.reference.registration",
                      "vilbench.reference.vil", "vilbench.reference.lidar", "vilbench.sim.sim"])
    assert not top & {"jax", "jaxlib", "flax", "vil_fusion_tpu", "vil_fusion_tpu_torch"}
