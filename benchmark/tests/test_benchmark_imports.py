"""No run loads JAX or the JAX package, a run that has loaded one prints
no result, and the reference loads nothing of the port (top-level module
names compared whole, in a fresh interpreter)."""

import json
import subprocess
import sys

from benchmark import harness

RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests import runner
small = dict(height=64, width=128, batch_size=2, num_workers=2,
             compute_dtype="float32")
for cell in ("kitti640_train", "fork640_f32_serve16"):
    runner.result_line(cell, 5, 0.3, False, torch.device("cpu"),
                       overrides=small)
for m in harness.load_spec()["per_layer"]:
    harness.load_module(harness.HERE / "metrics" / (m["name"] + ".py"),
                        "m_" + m["name"].replace(".", "_"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

# a later reader that imports a module named jax (a stub): a copy of the
# benchmark with the reader planted, one traced run at a small size
PLANTED = """
import json, shutil, sys, torch
from pathlib import Path
torch.set_num_threads(2)
root = Path({root!r})
tmp = Path({tmp!r})
(tmp / "stub" / "jax").mkdir(parents=True)
(tmp / "stub" / "jax" / "__init__.py").write_text("")
shutil.copytree(root / "benchmark", tmp / "copy" / "benchmark",
                ignore=shutil.ignore_patterns("_cache", "__pycache__"))
spec = json.loads((root / "BENCHMARK.json").read_text())
spec["per_layer"].append(dict(name="planted", unit="ms", better="lower",
    source="program_span", layer="engine", moves="serve_p95_ms",
    workloads=["fork640_f32_serve16"]))
(tmp / "copy" / "BENCHMARK.json").write_text(json.dumps(spec))
(tmp / "copy" / "benchmark" / "metrics" / "planted.py").write_text(
    "import jax\\n\\ndef read(ctx):\\n    return 1.0\\n")
sys.path[:0] = [str(tmp / "copy"), str(tmp / "stub"), str(root)]
from benchmark import harness
assert harness.ROOT == tmp / "copy"
from benchmark.tests import runner
line, checks = runner.result_line(
    "fork640_f32_serve16", 5, 0.3, True, torch.device("cpu"),
    overrides=dict(height=64, width=128, compute_dtype="float32"))
assert "planted" in line["metrics"]
runner.report(line, checks)
"""

REFERENCE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark import inputs
from benchmark.reference import monodepth2 as ref
from benchmark.reference.precision import Precision
P = inputs.weights(ref.layout("fork", (0, 1, 2, 3)), 1, "cpu")
images = torch.zeros(1, 64, 128, 3, dtype=torch.uint8)
ref.infer(P, {{"depth_decoder_variant": "fork", "scales": (0, 1, 2, 3)}},
          images, Precision("float32"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def run_code(code, **names):
    return subprocess.run([sys.executable, "-c",
                           code.format(root=str(harness.ROOT), **names)],
                          capture_output=True, text=True, timeout=600,
                          cwd=str(harness.ROOT))


def loaded(code):
    out = run_code(code)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = loaded(RUN)
    assert "unsupervised_pose_estimation_tpu_torch" in top
    assert not top & set(harness.BANNED)


def test_a_run_that_loaded_jax_prints_no_result(tmp_path):
    out = run_code(PLANTED, tmp=str(tmp_path))
    assert out.returncode == 3, out.stderr[-2000:]
    assert "['jax']" in out.stderr
    assert "\"correct\"" not in out.stdout


def test_the_reference_loads_nothing_of_the_port():
    top = loaded(REFERENCE)
    assert "torch" in top
    assert not top & (set(harness.BANNED)
                      | {"unsupervised_pose_estimation_tpu_torch"})
