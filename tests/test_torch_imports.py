"""sqair_tpu_torch, chip_smoke.py, the port's tools (tools/*_torch.py) and
notebooks/play_torch.py import neither JAX nor the JAX package (the card's
machine has no JAX)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sqair_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "sqair_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "notebooks" / "play_torch.py"] + sorted(
        f for f in (REPO / "tools").glob("*_torch.py")
        if f.name != "jax_ckpt_to_torch.py")  # the converter reads JAX's checkpoints
    assert len([f for f in files if f.parent.name == "tools"]) >= 6
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


# the modules of the data pipeline and the configurations that the
# pedestrian and small-digit slice ported, and the rollout script and the
# figures (without matplotlib the figures are not drawn)
NEW_MODULES = ("sqair_tpu_torch.scripts.rollout", "sqair_tpu_torch.eval_tools",
               "sqair_tpu_torch.scripts.experiment",
               "sqair_tpu_torch.data.pedestrian", "sqair_tpu_torch.data.trajectory",
               "sqair_tpu_torch.data.moving_mnist", "sqair_tpu_torch.data.synthetic",
               "sqair_tpu_torch.configs.pedestrian_data", "sqair_tpu_torch.configs.pedestrian_model",
               "sqair_tpu_torch.configs.small_digit_mnist_model",
               "sqair_tpu_torch.configs.small_digit_seq_mnist_data",
               "sqair_tpu_torch.configs.font_seq_mnist_data",
               "sqair_tpu_torch.scripts.create_seq_mnist",
               # the conv model family and the model and optimizer options
               "sqair_tpu_torch.configs.conv_mnist_model", "sqair_tpu_torch.nn.layers",
               "sqair_tpu_torch.training.train",
               # data parallelism, the native binding, the tools and the notebook
               "sqair_tpu_torch.parallel.mesh", "sqair_tpu_torch.parallel.distributed",
               "sqair_tpu_torch.data.native", "sqair_tpu_torch.experiment.experiment_tools",
               "tools.time_step_torch", "tools.profile_step_torch", "tools.eval_one_ckpt_torch",
               "tools.diag_presence_logits_torch", "tools.promote_release_torch",
               "notebooks.play_torch")
_BLOCKED = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
m = importlib.import_module(sys.argv[1])
bad = [n for n in sys.modules if n.split(".")[0] in {blocked!r}]
assert not bad, bad
print(m.__name__)
"""


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_without_jax_or_matplotlib(module):
    """Each module is among the files checked above, and imports in a fresh
    interpreter in which jax, the JAX package and matplotlib cannot be
    imported (the card's machine has none of them)."""
    path = REPO / (module.replace(".", "/") + ".py")
    assert path.exists()
    blocked = FORBIDDEN + ("matplotlib",)
    out = subprocess.run([sys.executable, "-c", _BLOCKED.format(blocked=blocked), module],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == module
