"""The port stands alone: it imports neither JAX nor the JAX package, and
keeps library attention, ``torch.compile`` and kernel packages off its path.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# chip_smoke.py times library attention as a yardstick beside the kernels,
# so the last three patterns apply to the package alone
IMPORTS = [
    (r"^\s*(import|from)\s+jax\b", "imports jax"),
    (r"^\s*(import|from)\s+repro(\.|\s|$)", "imports the JAX package"),
]
OFF_PATH = [
    (r"scaled_dot_product_attention", "library attention"),
    (r"torch\.compile", "torch.compile"),
    (r"^\s*(import|from)\s+(flash_attn|xformers|flashinfer|vllm)\b",
     "a package of finished kernels"),
]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.models.bridge\n"
        "import repro_torch.kernels.ops, repro_torch.models.steps\n"
        "import repro_torch.serving.draft, repro_torch.serving.slots\n"
        "import repro_torch.models.mamba, repro_torch.kernels.ssm_scan\n"
        "import repro_torch.models.rotary, repro_torch.models.attention\n"
        "import repro_torch.models.blocks, repro_torch.models.transformer\n"
        "import repro_torch.serving.engine\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("pattern,what", IMPORTS + OFF_PATH)
def test_port_sources_stay_clean(pattern, what):
    assert (ROOT / "chip_smoke.py").is_file()
    files = PORT_FILES if (pattern, what) in IMPORTS else PORT_FILES[:-1]
    hits = []
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if re.search(pattern, code):
                hits.append(f"{path.relative_to(ROOT)}:{n}")
    assert not hits, f"{what}: {hits}"
