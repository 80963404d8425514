"""Port parity: ``repro_torch.benchmarks.check_regression`` against the
reference's ``benchmarks/check_regression.py``, on the CPU.

* ``SPECS`` names the reference's four files, their metrics and their
  gate paths.
* On copies of the committed ``bench_artifacts/BENCH_*.json``, both
  packages' ``check`` return the same failure lists: clean, after each
  package's ``_degrade`` (which write the same files), with a gate deleted,
  with a gate set false, with a required file missing, and with an empty
  directory.
* ``main(["--self-test", ...])`` returns 0, and 1 once ``_degrade`` copies
  the artifacts without degrading them.
"""

import json
import shutil
from pathlib import Path

import pytest

from benchmarks import check_regression as jcr
from repro_torch.benchmarks import check_regression as tcr

ART = Path(__file__).resolve().parents[1] / "bench_artifacts"


def _copy(dst: Path) -> Path:
    """The committed artifacts that ``SPECS`` names, copied to ``dst``."""
    dst.mkdir(parents=True, exist_ok=True)
    for fname in tcr.SPECS:
        shutil.copy(ART / fname, dst / fname)
    return dst


def _edit(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


def test_specs_equal_the_reference():
    assert list(tcr.SPECS) == list(jcr.SPECS)
    for fname, spec in tcr.SPECS.items():
        want = jcr.SPECS[fname]
        assert list(spec["metrics"]) == list(want["metrics"])
        assert spec["gates"] == want["gates"]
        d = json.loads((ART / fname).read_text())
        for name, fn in spec["metrics"].items():
            assert fn(d) == want["metrics"][name](d)


def _delete_gate(cur: Path):
    _edit(cur / "BENCH_serving_gateway.json",
          lambda d: d["gates"].pop("speedup_ge_2x"))
    return []


def _false_gate(cur: Path):
    _edit(cur / "BENCH_driver_overhead.json",
          lambda d: d.update(v4_socket_batch64_within_2x_twin=False))
    return []


def _missing_required(cur: Path):
    (cur / "BENCH_e2e_accuracy.json").unlink()
    return ["BENCH_e2e_accuracy.json", "BENCH_serving_gateway.json"]


def _empty(cur: Path):
    for f in cur.iterdir():
        f.unlink()
    return []


CASES = {"clean": lambda cur: [], "gate_deleted": _delete_gate,
         "gate_false": _false_gate, "required_missing": _missing_required,
         "empty": _empty}


@pytest.mark.parametrize("case", list(CASES))
def test_check_gives_the_reference_failures(tmp_path, case):
    base = _copy(tmp_path / "baseline")
    cur = _copy(tmp_path / "current")
    require = CASES[case](cur)
    got = tcr.check(str(base), str(cur), 0.25, require)
    assert got == jcr.check(str(base), str(cur), 0.25, require)
    assert bool(got) == (case != "clean")


def test_check_after_degrade_gives_the_reference_failures(tmp_path):
    base = _copy(tmp_path / "baseline")
    tcr._degrade(str(base), str(tmp_path / "port"))
    jcr._degrade(str(base), str(tmp_path / "reference"))
    for fname in tcr.SPECS:
        assert json.loads((tmp_path / "port" / fname).read_text()) == \
            json.loads((tmp_path / "reference" / fname).read_text())
    failures = tcr.check(str(base), str(tmp_path / "port"), 0.25, [])
    assert failures == jcr.check(str(base), str(tmp_path / "port"), 0.25, [])
    assert failures == jcr.check(str(base), str(tmp_path / "reference"),
                                 0.25, [])
    # every file's degradation is caught
    assert {f.split(":", 1)[0] for f in failures} == set(tcr.SPECS)


def test_self_test_rejects_the_degraded_copy(tmp_path):
    base, cur = _copy(tmp_path / "baseline"), _copy(tmp_path / "current")
    argv = ["--baseline", str(base), "--current", str(cur), "--self-test"]
    assert tcr.main(argv) == 0


def test_self_test_fails_when_nothing_is_degraded(tmp_path, monkeypatch):
    def copy_unchanged(src_dir, dst_dir):
        for fname in tcr.SPECS:
            shutil.copy(Path(src_dir) / fname, Path(dst_dir) / fname)

    monkeypatch.setattr(tcr, "_degrade", copy_unchanged)
    base, cur = _copy(tmp_path / "baseline"), _copy(tmp_path / "current")
    argv = ["--baseline", str(base), "--current", str(cur), "--self-test"]
    assert tcr.main(argv) == 1
