"""Nothing the benchmark runs loads JAX or the JAX package. Module names are
compared whole: the port's name begins with the JAX package's."""

import subprocess
import sys

from wsbench import catalog, harness

PROBE = """
import sys, pkgutil, importlib
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + '/wsbench/tests')
import wsbench
for m in pkgutil.iter_modules(wsbench.__path__):
    importlib.import_module('wsbench.' + m.name)
from conftest import tiny_cell
from wsbench import catalog, harness
for e in catalog.benchmark()['per_layer']:
    catalog.metric(e['name'])
r = harness.run_cell(tiny_cell('postfilter-200k-d128.frac2-2'), 9, 0.1, True, device='cpu')
assert r is not None and r['correct'], r
print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))
"""


def test_no_jax_in_a_run():
    p = subprocess.run([sys.executable, "-c", PROBE, str(catalog.REPO)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(p.stdout.split())
    assert "rangefilteredann_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "rangefilteredann_tpu"}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rangefilteredann_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "rangefilteredann_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(harness.forbidden_modules()) - base == {"rangefilteredann_tpu", "jaxlib"}


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    from conftest import tiny_cell

    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.run_cell(tiny_cell("prefilter-1m-d128.frac2-2"), 1, 0.1, False,
                            device="cpu") is None
