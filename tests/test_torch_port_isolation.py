"""The port stands alone: it imports neither JAX nor the JAX package.

Guards the rule for every later slice: ``pranet2_tpu_torch`` keeps its own
copies of whatever it needs from ``pranet2_tpu``.  Also checks that
``chip_smoke.py`` refuses to run, and prints no result, where it cannot
do its job.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pranet2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pranet2_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
    code = ("import sys, pranet2_tpu_torch, pranet2_tpu_torch.serve\n"
            "import pranet2_tpu_torch.train.binary, pranet2_tpu_torch.losses\n"
            "import pranet2_tpu_torch.evalx, pranet2_tpu_torch.data\n"
            "import pranet2_tpu_torch.utils.checkpoint\n"
            "import pranet2_tpu_torch.cli.train_binary\n"
            "import pranet2_tpu_torch.cli.test_binary\n"
            "import pranet2_tpu_torch.cli.eval_binary\n"
            "import pranet2_tpu_torch.cli.benchmark\n"
            "import pranet2_tpu_torch.utils.profiling\n"
            "import pranet2_tpu_torch.models.backbones.resnet\n"
            "import pranet2_tpu_torch.models.emcad\n"
            "import pranet2_tpu_torch.losses.multiclass\n"
            "import pranet2_tpu_torch.train.multiclass\n"
            "import pranet2_tpu_torch.train.extras\n"
            "import pranet2_tpu_torch.evalx.volumetric\n"
            "import pranet2_tpu_torch.data.volumes\n"
            "import pranet2_tpu_torch.cli.train_multiclass\n"
            "import pranet2_tpu_torch.cli.test_multiclass\n"
            "import pranet2_tpu_torch.models.backbones.maxvit\n"
            "import pranet2_tpu_torch.models.decoders\n"
            "import pranet2_tpu_torch.models.merit\n"
            "import pranet2_tpu_torch.models.mist\n"
            "import pranet2_tpu_torch.parallel\n"
            "import pranet2_tpu_torch.parallel.distributed\n"
            "import pranet2_tpu_torch.parallel.sync_batchnorm\n"
            "import pranet2_tpu_torch.parallel.spawn\n"
            "import pranet2_tpu_torch.data.preprocess\n"
            "import pranet2_tpu_torch.utils.logging_utils\n"
            "import pranet2_tpu_torch.cli.reproduce_baseline\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix()
                   for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
