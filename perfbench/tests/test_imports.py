"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names (the program's name begins with the JAX
package's), and the reference loads nothing of the program."""
import os
import subprocess
import sys

from perfbench.core.manifest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "materialrefgs_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
                          "for m in sys.modules})))"], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    tops = _loaded("import perfbench.run, perfbench.control, perfbench.core.cell, perfbench.cost\n"
                   "from perfbench.core.manifest import Cell, load_manifest\n"
                   "m = load_manifest()\n"
                   "[Cell(m, w['name']) for w in m['workloads']]\n"
                   "import materialrefgs_torch.train.trainer, materialrefgs_torch.render.envgs")
    assert not tops & set(FORBIDDEN)
    assert "materialrefgs_torch" in tops  # the whole-name comparison: this is allowed


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import perfbench.reference.plain.train.trainer, perfbench.reference.plain.render.envgs, "
                   "perfbench.reference.plain.evaluate, perfbench.reference.plain.train.lpips")
    assert not tops & (set(FORBIDDEN) | {"materialrefgs_torch"})


def test_forbidden_check_compares_whole_names(monkeypatch):
    from perfbench import run

    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "materialrefgs_tpu_extra.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
