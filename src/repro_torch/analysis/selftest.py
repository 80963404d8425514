"""``--self-test``: prove every rule fires, and stays quiet when clean.

A gate that cannot demonstrate it would catch the failure it exists for
is not a gate.  For each rule code we materialize a minimal fixture tree
with exactly one injected violation, run the engine over it, and require
the code to fire there, and *not* to fire on the corresponding clean
twin.  The fixtures carry the port's layout (``repro_torch/hw/...``,
``repro_torch/kernels/...`` beside ``repro_torch/csrc/*.cu``), since the
rules find their files by module name.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

from .engine import all_rules, run_lint

__all__ = ["CASES", "Case", "run_self_test", "materialize"]


@dataclasses.dataclass(frozen=True)
class Case:
    code: str
    bad: dict      # rel path -> source with exactly one violation
    clean: dict    # rel path -> source that must not fire the code


# --- wire-protocol fixture trio ---------------------------------------------

def _trio(ops, server_ops, client_ops, *, wire_internal=(), pipelined=(),
          job_reads_draws=True):
    """A minimal protocol trio.  ``server_ops`` / ``client_ops`` map op ->
    payload keys (server: read hard; client: encoded).  Every trio also
    carries the op ``job``, whose client sends ``gen`` and a Python
    ``draws`` that ``_wire_kw`` pops and re-encodes, and whose server
    reads ``draws`` one helper call deep (``_draws(driver, kw)``), unless
    ``job_reads_draws`` is False."""
    ops = set(ops) | {"job"}
    driver = ("BATCHABLE_OPS = frozenset(%r)\n"
              "WIRE_INTERNAL_OPS = frozenset(%r)\n"
              % (sorted(ops), sorted(wire_internal)))
    branches = "".join(
        "    if op == %r:\n        return {%s}\n" % (
            op, ", ".join("%r: kw[%r]" % (k, k) for k in keys) or "'ok': 1")
        for op, keys in server_ops.items())
    helper = ("def _draws(driver, kw):\n"
              + ("    if kw.get('draws') is not None:\n"
                 "        return kw['draws']\n" if job_reads_draws else "")
              + "    return kw.get('key')\n")
    server = (helper + "def _dispatch(driver, op, kw):\n" + branches
              + "    if op == 'job':\n"
                "        return {'cfg': kw['cfg'],\n"
                "                'draws': _draws(driver, kw)}\n"
              + "    raise ValueError(op)\n")
    methods = "".join(
        "    def %s(self, **kw):\n"
        "        return self._exec(%r, self._wire_kw(%r, dict(%s)))\n" % (
            op.replace("/", "_"), op, op,
            ", ".join("%s=kw[%r]" % (k, k) for k in keys))
        for op, keys in client_ops.items())
    client = ("PIPELINED_OPS = frozenset(%r)\n"
              "class StreamDriver:\n"
              "    def _exec(self, op, kw):\n"
              "        return (op, kw)\n"
              "    def _wire_kw(self, op, kw):\n"
              "        if op == 'job':\n"
              "            gen, draws = kw.pop('gen'), kw.pop('draws')\n"
              "            kw['draws'] = draws if draws is not None else gen\n"
              "        return kw\n"
              "    def job(self, cfg, gen=None, draws=None):\n"
              "        return self._exec('job', self._wire_kw(\n"
              "            'job', dict(cfg=cfg, gen=gen, draws=draws)))\n"
              % (sorted(pipelined),)) + methods
    return {"repro_torch/hw/driver.py": driver,
            "repro_torch/hw/server.py": server,
            "repro_torch/hw/stream_driver.py": client}


_WIRED = _trio({"ping"}, {"ping": ["x"]}, {"ping": ["x"]})


# --- kernels fixture: build.py, one wrapper, its plain version, its .cu -----

_BUILD = (
    "SOURCES = {'toy': 'toy.cu'}\n"
    "KERNELS = {'toy': 'toy'}\n"
    "launch_counts = dict.fromkeys(KERNELS, 0)\n"
    "def library(name):\n"
    "    import ctypes\n"
    "    lib = ctypes.CDLL(name)\n"
    "    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]\n"
    "    lib.repro_cuda_error_string.restype = ctypes.c_char_p\n"
    "    return lib\n"
    "def count_launch(name):\n"
    "    launch_counts[name] += 1\n"
    "def check_status(name, status):\n"
    "    if status != 0:\n"
    "        raise RuntimeError(library(name).repro_cuda_error_string(status))\n")

_CU = (
    '#include <cuda_runtime.h>\n'
    'extern "C" const char* repro_cuda_error_string(int status) {\n'
    '  return cudaGetErrorString(static_cast<cudaError_t>(status));\n'
    '}\n'
    '// y = x over n floats; nbytes = 4 n\n'
    'extern "C" int toy_run(const float* x, float* y, int n,\n'
    '                       long long nbytes, void* stream) {\n'
    '  return 0;\n'
    '}\n')

_WRAPPER_HEAD = (
    "import ctypes\n"
    "from . import build\n"
    "from .ref import toy_ref\n"
    "LIB = 'toy'\n"
    "NAME = 'toy'\n"
    "def _fn():\n"
    "    fn = build.library(LIB).toy_run\n"
    "    if fn.argtypes is None:\n"
    "        fn.argtypes = [ctypes.c_void_p] * 2 + %s\n"
    "        fn.restype = ctypes.c_int\n"
    "    return fn\n")

_WRAPPER_CALL = (
    "def toy(x, y, n, stream):\n"
    "    if x.device.type == 'cpu':\n"
    "        return toy_ref(x)\n"
    "    status = _fn()(x.data_ptr(), y.data_ptr(), n, 4 * n, stream)\n"
    "    build.check_status(LIB, status)\n"
    "    build.count_launch(%s)\n"
    "    return y\n")


def _kernels(argtypes="[ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]",
             counted="NAME", cu=_CU, body=None):
    """A kernels package: ``build.py`` with ``SOURCES`` / ``KERNELS``, a
    wrapper binding ``toy_run`` with ``argtypes`` (after two pointers), its
    plain version, and ``csrc/toy.cu``."""
    wrapper = _WRAPPER_HEAD % argtypes + (body or _WRAPPER_CALL % counted)
    return {"repro_torch/kernels/build.py": _BUILD,
            "repro_torch/kernels/toy.py": wrapper,
            "repro_torch/kernels/ref.py": "def toy_ref(x):\n    return x\n",
            "repro_torch/csrc/toy.cu": cu}


_KERNELS = _kernels()

_CAPTURE = (
    "import torch\n"
    "def _capture(body, pool):\n"
    "    graph = torch.cuda.CUDAGraph()\n"
    "    graph.capture_begin(pool=pool)\n"
    "    try:\n"
    "        body()\n"
    "    finally:\n"
    "        graph.capture_end()\n"
    "    return graph\n"
    "def search(st, steps):\n"
    "    def body():\n"
    "        st['x'].add_(1.0)\n"
    "%s"
    "    graph = _capture(lambda: body(), None)\n"
    "    for _ in range(steps):\n"
    "        graph.replay()\n"
    "    return float(st['x'].sum())\n")

_RECOMPUTE = (
    "from torch.utils.checkpoint import checkpoint\n"
    "from .layers import ptc_execution\n"
    "def stack(model, x, driver):\n"
    "    def body(x):\n"
    "%s"
    "    return checkpoint(body, x, use_reentrant=False)\n")

CASES = [
    Case(
        "RPT101",
        bad={"repro_torch/runtime/ctrl.py":
             "from ..hw.twin import make_twin\n"
             "def boot():\n    return make_twin\n"},
        clean={"repro_torch/runtime/ctrl.py":
               "from ..hw import make_twin\n"
               "def boot():\n    return make_twin\n"},
    ),
    Case(
        "RPT101",
        bad={"repro_torch/runtime/ctrl.py":
             "from ..hw import twin\n"
             "def boot():\n    return twin.make_twin\n"},
        clean={"repro_torch/benchmarks/ctrl.py":
               "from ..hw import twin\n"
               "def boot():\n    return twin.make_twin\n"},
    ),
    Case(
        "RPT102",
        bad={"repro_torch/core/opt.py":
             "def probe(driver):\n    return driver.unsafe_twin()\n"},
        clean={"repro_torch/runtime/fleet.py":
               "def probe(driver):\n    return driver.unsafe_twin()\n"},
    ),
    Case(
        "RPT103",
        bad={"repro_torch/core/opt.py":
             "def peek(hw):\n    return hw.realized_unitaries\n"},
        clean={"repro_torch/core/opt.py":
               "def peek(driver):\n    return driver.read_phases()\n"},
    ),
    Case(
        "RPT201",
        bad=_trio({"ping", "ghost"}, {"ping": ["x"]},
                  {"ping": ["x"], "ghost": ["x"]}),
        clean=_WIRED,
    ),
    Case(
        "RPT202",
        bad=_trio({"ping", "ghost"}, {"ping": ["x"], "ghost": ["x"]},
                  {"ping": ["x"]}),
        clean=_WIRED,
    ),
    Case(
        "RPT203",
        bad=_trio({"ping"}, {"ping": ["x"], "rogue": []},
                  {"ping": ["x"], "rogue": []}),
        clean=_trio({"ping"}, {"ping": ["x"], "merged": ["xs"]},
                    {"ping": ["x"], "merged": ["xs"]},
                    wire_internal={"merged"}),
    ),
    Case(
        "RPT203",
        bad=_trio({"ping"}, {"ping": ["x"]}, {"ping": ["x"]},
                  pipelined={"advance"}),
        clean=_trio({"ping"}, {"ping": ["x"]}, {"ping": ["x"]},
                    pipelined={"ping"}),
    ),
    Case(
        "RPT204",
        bad=_trio({"ping"}, {"ping": ["x", "y"]}, {"ping": ["x"]}),
        clean=_WIRED,
    ),
    Case(
        # the job's `draws`: popped and re-encoded by _wire_kw, read by the
        # server one helper call deep; the bad twin's helper never reads it
        "RPT204",
        bad=_trio({"ping"}, {"ping": ["x"]}, {"ping": ["x"]},
                  job_reads_draws=False),
        clean=_WIRED,
    ),
    Case(
        "RPT301",
        bad={"repro_torch/hw/jobs.py":
             _CAPTURE % "        print(st['x'].sum().item())\n"},
        clean={"repro_torch/hw/jobs.py": _CAPTURE % ""},
    ),
    Case(
        "RPT302",
        bad={"repro_torch/models/lm.py": _RECOMPUTE % (
            "        with ptc_execution(model, driver):\n"
            "            return model(x)\n")},
        clean={"repro_torch/models/lm.py": _RECOMPUTE % (
            "        return model(x)\n")},
    ),
    Case(
        # `long long nbytes` bound as a c_int
        "RPT401",
        bad=_kernels("[ctypes.c_int, ctypes.c_int, ctypes.c_void_p]"),
        clean=_KERNELS,
    ),
    Case(
        # one argument short
        "RPT401",
        bad=_kernels("[ctypes.c_int, ctypes.c_longlong]"),
        clean=_KERNELS,
    ),
    Case(
        "RPT402",
        bad=_kernels(cu=_CU.replace("toy_run", "toy_launch")),
        clean=_KERNELS,
    ),
    Case(
        "RPT403",
        bad=_kernels(counted="'toys'"),
        clean=_KERNELS,
    ),
    Case(
        "RPT404",
        bad=_kernels(body=(
            "def toy(x, y, n, stream):\n"
            "    try:\n"
            "        status = _fn()(x.data_ptr(), y.data_ptr(), n, 4 * n,\n"
            "                       stream)\n"
            "        build.check_status(LIB, status)\n"
            "    except RuntimeError:\n"
            "        return toy_ref(x)\n"
            "    build.count_launch(NAME)\n"
            "    return y\n")),
        clean=_kernels(body=(
            "def toy(x, y, n, stream):\n"
            "    try:\n"
            "        status = _fn()(x.data_ptr(), y.data_ptr(), n, 4 * n,\n"
            "                       stream)\n"
            "        build.check_status(LIB, status)\n"
            "    except RuntimeError as e:\n"
            "        raise RuntimeError(f'toy failed: {e}') from e\n"
            "    build.count_launch(NAME)\n"
            "    return y\n")),
    ),
    Case(
        "RPT501",
        bad={"repro_torch/runtime/seed.py":
             "import time\nimport torch\n"
             "def make_gen():\n"
             "    return torch.Generator().manual_seed(int(time.time()))\n"},
        clean={"repro_torch/runtime/seed.py":
               "import torch\n"
               "def make_gen(seed):\n"
               "    return torch.Generator().manual_seed(seed)\n"},
    ),
    Case(
        "RPT502",
        bad={"repro_torch/hw/frames.py":
             "def build(encode):\n"
             "    return [encode(op) for op in {'advance', 'charge'}]\n"},
        clean={"repro_torch/hw/frames.py":
               "def build(encode):\n"
               "    return [encode(op)\n"
               "            for op in sorted({'advance', 'charge'})]\n"},
    ),
]


def materialize(root: str, files: dict) -> None:
    """Write ``files`` (rel path -> text) under ``root``."""
    for rel, text in files.items():
        full = os.path.join(root, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "w", encoding="utf-8") as fh:
            fh.write(text)


def _codes(result) -> set:
    return {f.code for f in result.findings}


def run_case(case: Case) -> tuple[bool, bool]:
    """(fired on the bad tree, quiet on the clean one)."""
    with tempfile.TemporaryDirectory(prefix="repro-torch-lint-self-") as tmp:
        bad_root = os.path.join(tmp, "bad", "fixture")
        clean_root = os.path.join(tmp, "clean", "fixture")
        materialize(bad_root, case.bad)
        materialize(clean_root, case.clean)
        fired = case.code in _codes(run_lint([bad_root]))
        quiet = case.code not in _codes(run_lint([clean_root]))
    return fired, quiet


def run_self_test(emit=print) -> bool:
    """Inject one violation per case; return True iff every rule has a
    case, and every case fired on its bad fixture and stayed quiet on its
    clean twin."""
    covered = {c.code for c in CASES}
    known = {r.code for r in all_rules()}
    ok = True
    for missing in sorted(known - covered):
        emit(f"FAIL {missing}: no self-test fixture for this rule")
        ok = False
    for case in CASES:
        if case.code not in known:
            emit(f"FAIL {case.code}: fixture for unknown rule")
            ok = False
            continue
        fired, quiet = run_case(case)
        if fired and quiet:
            emit(f"ok   {case.code}: fires on injected violation, "
                 f"quiet on clean twin")
        else:
            detail = []
            if not fired:
                detail.append("did NOT fire on the injected violation")
            if not quiet:
                detail.append("fired on the clean twin")
            emit(f"FAIL {case.code}: " + "; ".join(detail))
            ok = False
    return ok
