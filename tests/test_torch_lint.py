"""The port's static checker, ``repro_torch.analysis`` (pure stdlib, CPU).

* Every self-test case fires its rule on its fixture and stays silent on
  the clean twin; ``--self-test`` passes.
* The real tree (``src/repro_torch``, ``chip_smoke.py``) lints clean with
  no ``# repro_torch: noqa`` line and no baseline; the reference's
  ``# repro: noqa`` tags hide nothing from it.
* Planted faults on copies of real files fire their rules: an ``argtypes``
  list one ``c_int`` short, a ``c_longlong`` turned into ``c_int``, a
  renamed ``extern "C"`` entry point, a misspelled launch counter, a
  fallback to ``ref.*`` around a kernel, the server no longer reading
  ``draws``, a ``.item()`` in the ZCD capture body.
* The wire model reads the real trio as the wire does (``_wire_kw`` pops
  ``gen`` and re-encodes ``draws``; the server reads ``draws`` one helper
  call deep), so the reference model's four false findings do not fire;
  every ``argtypes`` list of the wrappers folds, and the folded kinds are
  the ones the wrappers really set.
"""

import ast
import ctypes
import importlib
import json
import shutil
from pathlib import Path

import pytest

from repro_torch.analysis import lint, rules_kernels, rules_wire, selftest
from repro_torch.analysis.engine import all_rules, load_corpus, run_lint
from repro_torch.analysis.findings import noqa_codes

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
REAL = [str(PORT), str(REPO / "chip_smoke.py")]
CODES = ["RPT101", "RPT102", "RPT103", "RPT201", "RPT202", "RPT203",
         "RPT204", "RPT301", "RPT302", "RPT401", "RPT402", "RPT403",
         "RPT404", "RPT501", "RPT502"]


def _codes(paths):
    return sorted({f.code for f in run_lint(paths).findings})


# -- the rules and their self-test ----------------------------------------------

def test_rule_catalog():
    assert [r.code for r in all_rules()] == CODES
    assert {c.code for c in selftest.CASES} == set(CODES)


@pytest.mark.parametrize("i", range(len(selftest.CASES)),
                         ids=[f"{c.code}-{i}"
                              for i, c in enumerate(selftest.CASES)])
def test_self_test_case(i):
    fired, quiet = selftest.run_case(selftest.CASES[i])
    assert fired, "did not fire on the injected violation"
    assert quiet, "fired on the clean twin"


def test_self_test_cli_passes(capsys):
    assert lint.main(["--self-test"]) == 0
    out = capsys.readouterr().out
    for code in CODES:
        assert f"ok   {code}:" in out
    assert "FAIL" not in out


def test_package_is_stdlib_only():
    """No module of the checker imports torch, jax, numpy or the
    reference: only the standard library and its own modules."""
    allowed = {"ast", "argparse", "dataclasses", "hashlib", "json", "os",
               "re", "sys", "tempfile", "typing", "__future__"}
    for path in sorted((PORT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            assert {m.split(".")[0] for m in mods} <= allowed, (path, mods)


# -- the real tree --------------------------------------------------------------

def test_real_tree_is_clean():
    result = run_lint(REAL)
    assert not result.errors
    assert [f.format() for f in result.findings] == []
    # no port suppression, and no baseline to grandfather anything
    assert result.noqa_suppressed == []
    assert result.baseline_suppressed == []
    assert not (REPO / lint.DEFAULT_BASELINE).exists()


def test_no_port_noqa_line_in_the_tree():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + [REPO / "chip_smoke.py"]
    tagged = [f"{p.relative_to(REPO)}:{i}"
              for p in files
              for i, line in enumerate(p.read_text().splitlines(), 1)
              if noqa_codes(line) is not None
              and "analysis" not in p.parts]
    assert tagged == []


def test_reference_noqa_tag_hides_nothing(tmp_path):
    """``# repro: noqa`` (the reference checker's tag, kept on the port's
    hw lines because the reference still scans all of ``src``) does not
    hide an RPT finding; ``# repro_torch: noqa[RPT103]`` hides RPT103 and
    nothing else on the line."""
    line = "    x = DeviceRealization; y = driver.unsafe_twin()"
    src = tmp_path / "repro_torch" / "core" / "opt.py"
    src.parent.mkdir(parents=True)
    for tag, want in (("", ["RPT102", "RPT103"]),
                      ("  # repro: noqa", ["RPT102", "RPT103"]),
                      ("  # repro: noqa[RPL102, RPL103]",
                       ["RPT102", "RPT103"]),
                      ("  # repro_torch: noqa[RPT103]", ["RPT102"]),
                      ("  # repro_torch: noqa[RPT102, RPT103]", []),
                      ("  # repro_torch: noqa", [])):
        src.write_text(f"def f(driver):\n{line}{tag}\n    return x, y\n")
        result = run_lint([str(tmp_path)])
        assert sorted(f.code for f in result.findings) == want, tag
        assert len(result.noqa_suppressed) == 2 - len(want), tag


# -- the CLI --------------------------------------------------------------------

def test_cli_default_paths_exit_0(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert lint.main([]) == 0
    assert "clean — 0 finding(s)" in capsys.readouterr().out


def test_cli_findings_exit_1_and_json(tmp_path, capsys):
    selftest.materialize(str(tmp_path), selftest.CASES[0].bad)
    out_file = tmp_path / "findings.json"
    assert lint.main([str(tmp_path), "--json", str(out_file)]) == 1
    printed = capsys.readouterr().out
    assert "RPT101" in printed and "FAILED" in printed
    data = json.loads(out_file.read_text())
    assert data["ok"] is False
    assert [f["code"] for f in data["findings"]] == ["RPT101"]
    assert len(data["findings"][0]["fingerprint"]) == 16
    assert lint.main([str(tmp_path), "--json", "-", "-q"]) == 1
    data, end = json.JSONDecoder().raw_decode(capsys.readouterr().out)
    assert data["ok"] is False and data["errors"] == []
    # --select narrows the run: no RPT5xx finding there
    assert lint.main([str(tmp_path), "--select", "RPT501,RPT502"]) == 0


def test_cli_usage_errors_exit_2(capsys):
    assert lint.main(["--select", "RPT999"]) == 2
    assert lint.main(["--explain", "RPL101"]) == 2
    with pytest.raises(SystemExit) as e:
        lint.main(["--no-such-flag"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_explain_and_list_rules(capsys):
    assert lint.main(["--explain", "rpt401"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("RPT401 — ")
    assert "c_longlong" in out and "argtypes" in out
    assert lint.main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.strip().splitlines()]
    assert listed == CODES


def test_cli_baseline_grandfathers_and_goes_stale(tmp_path, capsys):
    tree = tmp_path / "tree"
    selftest.materialize(str(tree), selftest.CASES[0].bad)
    base = tmp_path / "baseline.json"
    assert lint.main([str(tree), "--baseline", str(base),
                      "--update-baseline"]) == 0
    assert lint.main([str(tree), "--baseline", str(base)]) == 0
    assert "1 baselined" in capsys.readouterr().out
    selftest.materialize(str(tree), selftest.CASES[0].clean)
    assert lint.main([str(tree), "--baseline", str(base)]) == 0
    assert "stale baseline entry" in capsys.readouterr().err


# -- planted faults on copies of real files -----------------------------------

def _copy(tmp_path, *parts):
    """Copy the port's ``parts`` (package-relative dirs or files) under
    ``tmp_path/repro_torch``, keeping the layout."""
    root = tmp_path / "repro_torch"
    for part in parts:
        src = PORT / part
        dst = root / part
        if src.is_dir():
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                "__pycache__"))
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    return root


def _edit(path, old, new, count=1):
    text = path.read_text()
    assert text.count(old) >= count, (path, old)
    path.write_text(text.replace(old, new, count))


PLANTED = {
    # sigma_grad's list one c_int short
    "sigma_grad_short": ("RPT401", "kernels/sigma_grad.py",
                         "[ctypes.c_int] * 7", "[ctypes.c_int] * 6"),
    # paged_kv's `long long` page/row bytes bound as a c_int
    "paged_kv_longlong": ("RPT401", "kernels/paged_kv.py",
                          "+ [ctypes.c_longlong, ctypes.c_int,",
                          "+ [ctypes.c_int, ctypes.c_int,"),
    # an extern "C" renamed in the copied source
    "renamed_entry": ("RPT402", "csrc/paged_kv.cu",
                      'extern "C" int paged_scatter(',
                      'extern "C" int paged_scatter_v2('),
    # a launch counter misspelled
    "counter_typo": ("RPT403", "kernels/paged_kv.py",
                     'build.count_launch("paged_gather")',
                     'build.count_launch("paged_gathr")'),
    # a try/except around the kernel that falls back to the plain version
    "hidden_fallback": ("RPT404", "kernels/paged_kv.py",
                        "    build.check_status(LIB, status)\n"
                        "    build.count_launch(\"paged_gather\")",
                        "    try:\n"
                        "        build.check_status(LIB, status)\n"
                        "    except RuntimeError:\n"
                        "        return paged_gather_ref(table, pages)\n"
                        "    build.count_launch(\"paged_gather\")"),
    # the server no longer reads a job's `draws`
    "server_drops_draws": ("RPT204", "hw/server.py",
                           'if kw.get("draws") is not None:\n'
                           '        draws = torch.from_numpy('
                           'np.ascontiguousarray(kw["draws"]))',
                           'if kw.get("key") is None:\n'
                           '        draws = torch.from_numpy('
                           'np.ascontiguousarray(kw["key"]))'),
    # a host sync in the ZCD step that is captured as a CUDA graph
    "capture_item": ("RPT301", "hw/jobs.py",
                     "        better = f_plus < st[\"f\"]\n",
                     "        better = f_plus < st[\"f\"]\n"
                     "        better.sum().item()\n"),
}
_GROUPS = {"kernels": ("kernels", "csrc"),
           "hw": ("hw/driver.py", "hw/server.py", "hw/stream_driver.py",
                  "hw/jobs.py")}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_fault_fires(tmp_path, name):
    code, rel, old, new = PLANTED[name]
    root = _copy(tmp_path, *_GROUPS[rel.split("/")[0] if rel.startswith("hw")
                                   else "kernels"])
    assert _codes([str(root)]) == [], "the unmodified copy is not clean"
    _edit(root / rel, old, new)
    result = run_lint([str(root)])
    fired = [f for f in result.findings if f.code == code]
    assert fired, [f.format() for f in result.findings]
    if name == "renamed_entry":
        assert any("paged_scatter_v2" in f.message for f in fired)
        assert any("binds paged_scatter," in f.message for f in fired)
    if name == "server_drops_draws":
        assert {("'draws'" in f.message, "zo_refine" in f.message
                 or "run_ic" in f.message) for f in fired} == {(True, True)}


def test_real_trio_reads_as_the_wire_does():
    corpus, errors = load_corpus([str(PORT / "hw")])
    assert not errors
    model = rules_wire.extract_wire_model(corpus)
    assert model.found == {"driver", "server", "client"}
    for op in ("zo_refine", "run_ic"):
        sent = set(model.client_keys[op])
        assert "gen" not in sent and "draws" in sent, op
        assert model.server_reads[op]["draws"] == "soft"
        assert model.server_reads[op]["cfg"] == "hard"
    assert model.server_reads["init"]["key"] == "hard"
    assert "key" not in model.client_keys["zo_refine"]
    # the four findings the reference's model gives on this trio (gen and
    # draws of zo_refine and run_ic) are absent
    assert _codes([str(PORT / "hw")]) == []


def _model():
    corpus, _ = load_corpus([str(PORT / "kernels")])
    return rules_kernels.extract_kernel_model(corpus)


def test_every_argtypes_list_folds():
    """Every ``.argtypes =`` line in the wrappers is folded (none escapes
    the check), and every C entry point is bound."""
    model = _model()
    written = {(p.name, i)
               for p in sorted((PORT / "kernels").glob("*.py"))
               for i, line in enumerate(p.read_text().splitlines(), 1)
               if ".argtypes =" in line}
    folded = {(Path(b.sf.rel).name, b.node.lineno)
              for b in rules_kernels._folded(model.bindings,
                                             rules_kernels._binding_known)
              if b.attr == "argtypes" and rules_kernels._binding_known(b)}
    assert len(written) == 25        # 24 in the wrappers, 1 in build.py
    assert folded == written
    entries = {e.name for es in model.entries.values() for e in es}
    assert len(entries) == 26        # 25 entry points + the error string
    assert sum(len(es) for es in model.entries.values()) == 35


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = None


class _FakeLib:
    """Stands in for a loaded library: records what a wrapper binds."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _FakeFn())


def _ctype(kind):
    if kind.startswith("POINTER("):
        return ctypes.POINTER(getattr(ctypes, kind[8:-1]))
    return getattr(ctypes, kind)


def test_folded_kinds_are_what_the_wrappers_set(monkeypatch):
    """The binding helpers, run against stand-in libraries, set exactly
    the kinds the checker folded (paged_kv's helper with its call sites'
    constants), and the tile entry points are bound with pointer
    outputs."""
    # the package re-exports functions under some module names: take the
    # modules themselves
    mod = {name: importlib.import_module(f"repro_torch.kernels.{name}")
           for name in ("build", "feedback_matmul", "mesh_apply", "paged_kv",
                        "prefill_attn", "ptc_block_matmul", "sigma_grad")}
    libs = {}
    monkeypatch.setattr(mod["build"], "library",
                        lambda name: libs.setdefault(name, _FakeLib()))
    pbm = mod["ptc_block_matmul"]
    for helper in (pbm._fns, pbm.wide_lib, pbm.tc_lib, pbm.tf32x3_lib,
                   mod["sigma_grad"]._lib, mod["feedback_matmul"]._lib,
                   mod["mesh_apply"].mesh_lib, mod["prefill_attn"]._fn,
                   mod["prefill_attn"]._fn_tc):
        helper()
    mod["paged_kv"]._fn("paged_gather", 3, 3)
    mod["paged_kv"]._fn("paged_scatter", 4, 3)
    model = _model()
    want = {(b.sym.lib, b.sym.name): b.value.items
            for b in rules_kernels._folded(model.bindings,
                                           rules_kernels._binding_known)
            if b.attr == "argtypes" and b.sym.lib != "*"}
    got = {(lib, name): fn.argtypes for lib, fake in libs.items()
           for name, fn in fake.fns.items() if fn.argtypes is not None}
    assert set(got) == set(want)
    for key, kinds in want.items():
        assert [t for t in got[key]] == [_ctype(k) for k in kinds], key
        assert libs[key[0]].fns[key[1]].restype is ctypes.c_int, key
    assert got[("ptc_block_matmul", "ptc_block_matmul_tile")][-1] \
        is ctypes.POINTER(ctypes.c_int)
    assert got[("sigma_grad", "sigma_grad_tile")] == \
        [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
