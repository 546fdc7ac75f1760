"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``.

Both run on the CPU (the reference on JAX's CPU backend, the port with
``--device cpu``), and their outputs hold the same verdicts: Figure 1's
two intervals, t3's COMMIT and the SI verification, and each scheduler's
committed, aborted, cross-msgs, coordinator-msgs and SI-violations line.
"""
import contextlib
import importlib.util
import io
import runpy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _lines(text):
    return [line.rstrip() for line in text.splitlines() if line.strip()]


def test_quickstart_torch_equals_the_reference(capsys):
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    want = _lines(ref.getvalue())
    assert got == want
    assert any("COMMIT with interval" in line for line in got)
    assert "history verifies as snapshot-isolated: True" in got
    scheds = [line for line in got if "SI-violations=" in line]
    assert [line.split()[0] for line in scheds] == ["postsi", "cv", "si",
                                                    "optimal"]
    assert all(line.endswith("SI-violations=0") for line in scheds)
