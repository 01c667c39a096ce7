"""PyTorch port: the package and chip_smoke.py stand alone.

Every ``repro_torch`` module imports with jax made unimportable, and no
source of the port (nor ``chip_smoke.py``) imports jax or the JAX
package ``repro``.
"""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|$|,)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for want in ('repro_torch.kernels.flash_attn.decode',\n"
        "             'repro_torch.kernels.wire_compress.ops',\n"
        "             'repro_torch.train.trainer',\n"
        "             'repro_torch.core.sdm_dsgd', 'repro_torch.prng',\n"
        "             'repro_torch.sim', 'repro_torch.sim.runner',\n"
        "             'repro_torch.bench.fig2_divergence',\n"
        "             'repro_torch.bench.run',\n"
        "             'repro_torch.bench.counting',\n"
        "             'repro_torch.bench.serve_bench',\n"
        "             'repro_torch.bench.check_serve',\n"
        "             'repro_torch.bench.perf_wire',\n"
        "             'repro_torch.bench.check_perf',\n"
        "             'repro_torch.configs.phi3_medium_14b',\n"
        "             'repro_torch.configs.chatglm3_6b',\n"
        "             'repro_torch.configs.qwen1_5_32b'):\n"
        "    assert want in names, (want, names)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35


def test_no_source_imports_jax_or_repro():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in _sources()
                 for m in _IMPORT_RE.finditer(p.read_text())]
    assert not offenders, offenders
    # the pattern itself catches what it must
    assert _IMPORT_RE.search("import jax.numpy as jnp")
    assert _IMPORT_RE.search("from repro.models import layers")
    assert not _IMPORT_RE.search("from repro_torch.models import layers")
