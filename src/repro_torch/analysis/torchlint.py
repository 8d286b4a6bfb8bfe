"""torchlint — AST checks for the PyTorch port's host-device discipline.

The port's counterpart of ``repro/analysis/jaxlint.py``, renamed because
nothing in it is JAX. Each check maps one of jaxlint's onto what the same
hazard is under PyTorch eager (``CHECKS`` is the catalogue):

* ``host-sync`` (jaxlint's ``host-sync``) — inside the engine's hot
  scheduling functions: device-to-host reads (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``np.asarray`` / ``np.array`` on a non-literal,
  ``int()`` / ``float()`` / ``bool()`` on an indexed value), explicit waits
  (``torch.cuda.synchronize()``, a stream's or event's ``.synchronize()``)
  and blocking host-to-device copies. A copy from pageable host memory
  without ``non_blocking=True`` ends in ``cudaMemcpyAsync`` followed by
  ``cudaStreamSynchronize`` (``c10::cuda::memcpy_and_sync``), so it drains
  the stream as a read does: ``torch.tensor(..., device=...)``,
  ``torch.as_tensor(..., device=...)``, ``.to(<a device>)``, ``.cuda()``,
  the repo's upload helpers (``LintConfig.upload_helpers``) and a Python
  scalar stored through an index that may be a tensor (``x[:, ids] = 0``:
  ``index_put_`` uploads the scalar).
* ``model-sync`` (jaxlint's ``traced-flow``) — the counterpart of a jit
  body is the model code a dispatch runs eagerly on the host
  (``repro_torch/models/``, ``kernels/``, ``sharding/``, less the cold
  functions of ``LintConfig.model_cold``): ``if`` / ``while`` on a
  parameter annotated ``torch.Tensor`` (``is None`` and shape / dtype /
  device reads stay exempt), ``int()`` / ``float()`` / ``bool()`` of one,
  and every ``host-sync`` pattern.
* ``retrace`` (jaxlint's ``retrace``) — a model dispatch of the engine
  (``self.model.prefill``, ``prefill_chunk``, ``decode_step``, …; no JIT)
  fed a tensor sliced to a Python-varying extent outside the blessed
  bucketing helpers: each extent is a new dispatch shape (a new
  ``Engine._note_shape`` entry) and, once the steps are captured, one more
  CUDA-graph capture.
* ``kernel-grid`` (jaxlint's ``pallas-grid``) — an int constant other
  than 0 / 1 among the arguments of a call into the built kernel library
  (``_build.load().rt_*(...)``): launch geometry comes from named
  constants or the C planner (``rt_decode_plan``).
* ``kernel-test`` (jaxlint's ``pallas-test``) — a public module-level
  function of ``repro_torch/kernels/*.py`` that reaches ``_build.load()``
  has no ``<name>_plain`` beside it (the plain version the CPU runs, the
  port's counterpart of ``interpret=``), or is named in no file under the
  tests directory, or not in ``chip_smoke.py``.

jaxlint's ``donated-use`` has no counterpart: PyTorch donates no buffer,
and the port's engine writes its caches in place by design (one
preallocated pool that every dispatch updates).

Design notes, as jaxlint's:

* Analysis is per-module and approximate: it sees syntax, not types. A
  ``.tolist()`` on a numpy array is flagged like one on a CUDA tensor;
  such findings are triaged into the baseline as false positives.
* Suppression: a finding is dropped when its line (or an immediately
  preceding comment-only line run) carries
  ``# torchlint: disable=<check>[,<check>…]`` (or ``disable=all``), with
  an optional ``-- reason`` tail. ``analyze_paths(..., suppressed=True)``
  also returns the dropped findings, with ``Finding.suppressed`` holding
  the reason (``""`` when none was given), so a runtime census of the
  syncs PyTorch reports can tell an accepted sync from an unseen one.
* Fingerprints are line-number-free: ``md5(check|path|qualname|stripped
  source line|occurrence)``, the occurrence counted among the findings
  kept (suppressed ones count apart). Baselines survive unrelated edits
  but go stale when the flagged line itself changes.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# check name -> one-line contract (shown by --list-checks)
CHECKS: Dict[str, str] = {
    "host-sync": (
        "host-device synchronization inside a configured hot-path "
        "function: device-to-host reads (.item(), .tolist(), .cpu(), "
        ".numpy(), np.asarray/np.array, int()/float()/bool() on indexed "
        "values), explicit waits (.synchronize()) and blocking "
        "host-to-device copies (torch.tensor/as_tensor(device=), "
        ".to(<device>), .cuda() without non_blocking=True, the upload "
        "helpers, a Python scalar stored through a tensor index)"),
    "model-sync": (
        "model code a dispatch runs eagerly (models/, kernels/, "
        "sharding/) branches on (or converts with int/float/bool) a "
        "torch.Tensor parameter, or holds a host-sync pattern — each one "
        "drains the stream on the card"),
    "retrace": (
        "a model dispatch is fed a tensor sliced to a Python-varying "
        "extent outside the blessed bucketing helpers — every distinct "
        "extent is a new dispatch shape (and CUDA-graph capture)"),
    "kernel-grid": (
        "a call into the built kernel library (rt_*) passes a bare magic "
        "number instead of a named constant or a planner's result (0 and "
        "1 are allowed)"),
    "kernel-test": (
        "a public kernel wrapper (reaches _build.load()) lacks a "
        "<name>_plain version beside it, or is named in no file under "
        "tests/, or is not driven by chip_smoke.py"),
}

_NP_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_D2H_ATTRS = {"item", "tolist", "cpu", "numpy"}
_WAIT_CALLS = {"torch.cuda.synchronize"}
_H2D_CALLS = {"torch.tensor", "torch.as_tensor"}
_CONVERT = ("int", "float", "bool")
_HOST_LITERALS = (ast.List, ast.ListComp, ast.Tuple, ast.GeneratorExp,
                  ast.Dict, ast.DictComp, ast.Constant)
_TENSOR_ANNOTATIONS = {"torch.Tensor", "Tensor"}
_SCALAR_ANNOTATIONS = {"int", "bool", "float", "str"}
# reads of a tensor that stay on the host (metadata, no device value)
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "is_floating_point", "is_complex", "dim",
               "size", "numel", "stride", "is_contiguous", "element_size",
               "data_ptr", "names", "grad_fn", "is_leaf", "nbytes",
               "itemsize"}
_META_CALLS = {"len", "isinstance", "id", "type"}

# the engine's model dispatches (the counterpart of jaxlint's jit'd
# registry), by dotted callee
_DISPATCH_RE = re.compile(
    r"^(self\.)?model\.(prefill|prefill_kv|prefill_chunk|prefill_suffix|"
    r"decode_step|encode|cross_kv)$")
# report paths of the model code a dispatch runs eagerly, and of the
# kernel wrapper modules; the call that loads the built kernel library
_MODEL_PATH_RE = re.compile(r"(^|/)repro_torch/(models|kernels|sharding)/")
_KERNEL_PATH_RE = re.compile(r"(^|/)repro_torch/kernels/[^/]+\.py$")
_LIBRARY_LOADER = "_build.load"

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([\w\-,]+)(?:\s*--\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str
    path: str              # as reported (display)
    line: int
    col: int
    qualname: str
    message: str
    fingerprint: str
    # None: reported; a string: dropped by an inline disable, its reason
    suppressed: Optional[str] = None

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.check} "
                f"[{self.fingerprint}] {self.qualname}: {self.message}")


@dataclasses.dataclass
class LintConfig:
    """Repo-tuned knobs. Defaults encode THIS codebase's conventions."""
    # qualname regexes whose bodies are hot scheduling/dispatch paths —
    # host syncs here stall the engine's per-step pipeline: jaxlint's
    # list, then the port's helpers that Engine.step and admit_many reach
    hot_functions: Tuple[str, ...] = (
        r"^Engine\.step$",
        r"^Engine\._ensure_grow$",
        r"^Engine\._advance_pending$",
        r"^Engine\._finish_pending$",
        r"^Engine\._admit_group$",
        r"^Engine\._admit_group_suffix$",
        r"^Engine\._scatter_group$",
        r"^Engine\._preempt$",
        r"^Engine\.export_kv$",
        r"^Engine\.export_live_kv$",
        r"^Engine\.admit_many$",
        r"^Engine\._admit_one_legacy$",
        r"^Engine\._decode$",
        r"^Engine\._sync_block_tbl$",
        r"^Engine\._check_probe$",
        r"^Engine\._install$",
        r"^Engine\._cow$",
        r"^Engine\._dev$",
        r"^Engine\._prompt$",
        r"^Engine\._frames$",
        r"^Engine\._chunk_init$",
        r"^Engine\._free_blocks$",
        r"^Engine\._poison_released$",
        r"^Engine\._readmit_preempted$",
        r"^Engine\.import_kv$",
    )
    # qualname regexes blessed to feed model dispatches shape-varying
    # data — the power-of-2 bucketing helpers pad before dispatch
    blessed_retrace: Tuple[str, ...] = (
        r"^Engine\._admit_group$",
        r"^Engine\._admit_group_suffix$",
        r"^Engine\._bucket$",
        r"^Engine\.bucket_lens$",
    )
    # helpers that upload host data with a blocking copy
    upload_helpers: Tuple[str, ...] = ("self._dev",)
    # regexes searched in "<path>::<qualname>" of model-path functions no
    # dispatch runs: the conversion of the reference's parameters,
    # parameter init and schemas, the plain versions (the CPU's oracles)
    # and the launch counters' resets (``init_cache`` is not cold: a
    # contig chunked group builds its transient cache at admission)
    model_cold: Tuple[str, ...] = (
        r"/models/convert\.py::",
        r"::(\w+\.)*(init|init_params|_init_tensor|\w*schema\w*|\w+_plain|"
        r"reset_\w+)$",
    )
    # directory whose files provide the kernel-test cross-reference
    tests_dir: Optional[str] = None
    # the card smoke script that must drive every kernel wrapper
    smoke_file: Optional[str] = None
    enabled: Tuple[str, ...] = tuple(CHECKS)
    grid_allowed_ints: Tuple[int, ...] = (0, 1)


# -- small AST helpers ----------------------------------------------------------
def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.tensor' / 'self._dev' / 'np.asarray' for Name/Attribute
    chains; None for anything else (calls, subscripts…)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _walk_local(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes of ``fn``'s own body, NOT descending into nested function or
    class definitions — those are visited separately under their own
    qualname (so per-function policy like hot/blessed applies to the
    innermost enclosing function, and nothing is analyzed twice)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _parents(root: ast.AST) -> Dict[ast.AST, ast.AST]:
    par: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _suppressions(source: str) -> Dict[int, Tuple[Set[str], str]]:
    out: Dict[int, Tuple[Set[str], str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = (set(m.group(1).split(",")), (m.group(2) or "").strip())
    return out


def _suppressed(check: str, line: int,
                sup: Dict[int, Tuple[Set[str], str]],
                lines: Sequence[str]) -> Optional[str]:
    """The disable's reason if the finding's line, or the run of
    comment-only lines immediately above it, carries a matching disable;
    else None."""
    def hit(ln: int) -> Optional[str]:
        s = sup.get(ln)
        if s is not None and (check in s[0] or "all" in s[0]):
            return s[1]
        return None

    reason = hit(line)
    if reason is not None:
        return reason
    ln = line - 1
    while 1 <= ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"):
        reason = hit(ln)
        if reason is not None:
            return reason
        ln -= 1
    return None


def _annotated(fn, names: Set[str]) -> Set[str]:
    """``fn``'s parameters whose annotation is one of ``names``."""
    args = fn.args
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.annotation is not None and _dotted(a.annotation) in names}


def _is_meta(node: ast.AST) -> bool:
    """A read of tensor metadata (``x.shape[0]``, ``q.ndim``): host data."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            return True
        node = node.value
    return False


def _scalar_store(stmt: ast.AST) -> Optional[str]:
    """A Python scalar (a number, or a module constant in capitals)
    assigned through an index that may be a tensor (``x[:, ids] = 0``):
    ``index_put_`` uploads the scalar with a blocking copy."""
    if not isinstance(stmt, ast.Assign):
        return None
    val = stmt.value
    if isinstance(val, ast.UnaryOp) and isinstance(val.op, ast.USub):
        val = val.operand
    scalar = (isinstance(val, ast.Constant)
              and isinstance(val.value, (int, float))) or (
        isinstance(val, ast.Name) and val.id.isupper())
    if not scalar:
        return None
    for tgt in stmt.targets:
        if not isinstance(tgt, ast.Subscript):
            continue
        parts = (tgt.slice.elts if isinstance(tgt.slice, ast.Tuple)
                 else [tgt.slice])
        if any(not isinstance(p, (ast.Slice, ast.Constant)) for p in parts):
            return (f"`{ast.unparse(tgt)} = {ast.unparse(stmt.value)}` "
                    f"stores a Python scalar through an index: a blocking "
                    f"upload (index_put_) if the index is a tensor")
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_device(node: Optional[ast.AST]) -> bool:
    """A device-looking argument: 'cuda' / 'cpu' / 'cuda:N', a name whose
    last part is ``device`` or ``dev`` (``self.device``, ``q.device``),
    or ``torch.device(...)``."""
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and (
            node.value in ("cpu", "cuda") or node.value.startswith("cuda:"))
    if isinstance(node, ast.Call):
        return _dotted(node.func) == "torch.device"
    name = _dotted(node)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in ("device", "dev") or last.endswith(("_device", "_dev"))


class _Scoped(ast.NodeVisitor):
    """Base visitor that tracks class/function qualnames."""

    def __init__(self) -> None:
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _visit_fn(self, node) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


# -- per-module analysis --------------------------------------------------------
class _ModuleLinter:
    def __init__(self, path: str, rel: str, source: str,
                 config: LintConfig, tests_blob: str,
                 smoke_blob: str) -> None:
        self.rel = rel.replace(os.sep, "/")
        self.lines = source.splitlines()
        self.config = config
        self.tests_blob = tests_blob
        self.smoke_blob = smoke_blob
        self.tree = ast.parse(source, filename=path)
        self.sup = _suppressions(source)
        self.raw: List[Tuple[str, int, int, str, str, Optional[str]]] = []
        self._hot = [re.compile(p) for p in config.hot_functions]
        self._blessed = [re.compile(p) for p in config.blessed_retrace]
        self._cold = [re.compile(p) for p in config.model_cold]
        self._model = bool(_MODEL_PATH_RE.search(self.rel))
        self._kernel = bool(_KERNEL_PATH_RE.search(self.rel))

    # -- emit helpers ------------------------------------------------------
    def _emit(self, check: str, node: ast.AST, qualname: str,
              message: str) -> None:
        if check not in self.config.enabled:
            return
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        reason = _suppressed(check, line, self.sup, self.lines)
        self.raw.append((check, line, col, qualname, message, reason))

    def findings(self) -> List[Finding]:
        seen: Dict[Tuple[str, str, str, bool], int] = {}
        out: List[Finding] = []
        for check, line, col, qualname, message, reason in sorted(
                self.raw, key=lambda r: r[:5]):
            src = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
            key = (check, qualname, src, reason is not None)
            occ = seen.get(key, 0)
            seen[key] = occ + 1
            fp = hashlib.md5(
                f"{check}|{self.rel}|{qualname}|{src}|{occ}"
                .encode()).hexdigest()[:16]
            out.append(Finding(check, self.rel, line, col, qualname,
                               message, fp, reason))
        return out

    def run(self) -> List[Finding]:
        self._walk_functions()
        self._check_kernel_grid()
        self._check_kernel_test()
        return self.findings()

    # -- function-scoped checks -------------------------------------------
    def _walk_functions(self) -> None:
        linter = self

        class V(_Scoped):
            def _visit_fn(self, node) -> None:
                self._stack.append(node.name)
                qn = self.qualname
                if any(r.search(qn) for r in linter._hot):
                    linter._check_host_sync(node, qn)
                if linter._model and not any(
                        r.search(f"{linter.rel}::{qn}")
                        for r in linter._cold):
                    linter._check_model_sync(node, qn)
                if not any(r.search(qn) for r in linter._blessed):
                    linter._check_retrace(node, qn)
                self.generic_visit(node)
                self._stack.pop()

            visit_FunctionDef = _visit_fn
            visit_AsyncFunctionDef = _visit_fn

        V().visit(self.tree)

    # host-sync ------------------------------------------------------------
    def _sync_pattern(self, node: ast.Call,
                      host: Set[str]) -> Optional[str]:
        """What a host-sync pattern at this call does, or None. ``host``:
        the function's parameters annotated as Python scalars."""
        callee = _dotted(node.func)
        attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                else None)
        if callee in _NP_CALLS:
            if node.args and isinstance(node.args[0], _HOST_LITERALS):
                return None       # pure host construction, no device sync
            return f"`{callee}` pulls a device value to the host"
        if callee in _WAIT_CALLS or (attr == "synchronize"
                                     and not node.args):
            return f"`{callee or '.synchronize'}()` waits for the device"
        if attr in _D2H_ATTRS and not node.args:
            return f"`.{attr}()` copies a device value to the host"
        if callee in _CONVERT and len(node.args) == 1 and isinstance(
                node.args[0], (ast.Subscript, ast.Name, ast.Attribute)) \
                and _dotted(node.args[0]) not in host \
                and not _is_meta(node.args[0]):
            return (f"`{callee}()` on a named or indexed value syncs if it "
                    f"is a device tensor")
        if callee in _H2D_CALLS and _kw(node, "device") is not None and \
                not (isinstance(_kw(node, "device"), ast.Constant)
                     and _kw(node, "device").value is None):
            return (f"`{callee}(..., device=)` from host data is a blocking "
                    f"copy (memcpy and stream sync)")
        if attr == "to" and not _is_true(_kw(node, "non_blocking")) and (
                _is_device(_kw(node, "device"))
                or (node.args and _is_device(node.args[0]))):
            return ("`.to(<device>)` without non_blocking=True is a "
                    "blocking copy across devices")
        if attr == "cuda" and not _is_true(_kw(node, "non_blocking")):
            return "`.cuda()` without non_blocking=True is a blocking copy"
        if callee in self.config.upload_helpers:
            return (f"`{callee}()` uploads host data with a blocking copy "
                    f"(memcpy and stream sync)")
        return None

    def _check_host_sync(self, fn, qualname: str, check: str = "host-sync",
                         where: str = "hot path") -> Set[ast.AST]:
        """Emit every host-sync pattern of ``fn``; returns their nodes."""
        host = _annotated(fn, _SCALAR_ANNOTATIONS)
        hits: Set[ast.AST] = set()
        for node in _walk_local(fn):
            what = (self._sync_pattern(node, host)
                    if isinstance(node, ast.Call) else _scalar_store(node))
            if what is not None:
                hits.add(node)
                self._emit(check, node, qualname,
                           f"{what} inside {where} `{qualname}`")
        return hits

    # model-sync -----------------------------------------------------------
    def _check_model_sync(self, fn, qualname: str) -> None:
        hits = self._check_host_sync(fn, qualname, "model-sync",
                                     "model code")
        tensors = _annotated(fn, _TENSOR_ANNOTATIONS)
        if not tensors:
            return
        par = _parents(fn)

        def uses_tensor(node: ast.AST) -> Optional[str]:
            """A tensor parameter read for its value (not its metadata)."""
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Name) and sub.id in tensors):
                    continue
                up = par.get(sub)
                if isinstance(up, ast.Attribute) and up.attr in _META_ATTRS:
                    continue
                if isinstance(up, ast.Call) and \
                        _dotted(up.func) in _META_CALLS:
                    continue
                return sub.id
            return None

        for node in _walk_local(fn):
            if isinstance(node, (ast.If, ast.While)):
                test = node.test
                if (isinstance(test, ast.Compare) and all(
                        isinstance(op, (ast.Is, ast.IsNot))
                        for op in test.ops)):
                    continue   # `is (not) None` on optionals is static
                name = uses_tensor(test)
                if name is not None:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    self._emit(
                        "model-sync", node, qualname,
                        f"`{kind}` on tensor `{name}` inside model code "
                        f"`{qualname}` reads its value on the host (a "
                        f"stream sync on the card)")
            elif isinstance(node, ast.Call) and node not in hits:
                callee = _dotted(node.func)
                if callee in _CONVERT and node.args:
                    name = uses_tensor(node.args[0])
                    if name is not None:
                        self._emit(
                            "model-sync", node, qualname,
                            f"`{callee}()` reads tensor `{name}` on the "
                            f"host inside model code `{qualname}`")

    # retrace --------------------------------------------------------------
    def _check_retrace(self, fn, qualname: str) -> None:
        for node in _walk_local(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func)
            if callee is None or not _DISPATCH_RE.search(callee):
                continue
            named = [(str(i), a) for i, a in enumerate(node.args)]
            named += [(kw.arg, kw.value) for kw in node.keywords
                      if kw.arg is not None]
            for label, arg in named:
                slc = self._varying_slice(arg)
                if slc is not None:
                    self._emit(
                        "retrace", arg, qualname,
                        f"arg {label} of dispatch `{callee}` is sliced to "
                        f"the Python-varying extent `{slc}` — every "
                        f"distinct extent is a new dispatch shape (pad to "
                        f"a bucket, or bless this helper in LintConfig)")

    @staticmethod
    def _varying_slice(arg: ast.AST) -> Optional[str]:
        for sub in ast.walk(arg):
            if not isinstance(sub, ast.Subscript):
                continue
            parts = (sub.slice.elts
                     if isinstance(sub.slice, ast.Tuple) else [sub.slice])
            for p in parts:
                if isinstance(p, ast.Slice):
                    for bound in (p.lower, p.upper):
                        if bound is not None and not isinstance(
                                bound, ast.Constant):
                            return ast.unparse(bound)
        return None

    # kernel-grid ----------------------------------------------------------
    def _check_kernel_grid(self) -> None:
        allowed = set(self.config.grid_allowed_ints)
        linter = self

        class V(_Scoped):
            def visit_Call(self, node: ast.Call) -> None:
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr.startswith("rt_"):
                    for a in node.args:
                        val = a
                        neg = (isinstance(a, ast.UnaryOp)
                               and isinstance(a.op, ast.USub))
                        if neg:
                            val = a.operand
                        if isinstance(val, ast.Constant) and \
                                type(val.value) is int:
                            n = -val.value if neg else val.value
                            if n not in allowed:
                                linter._emit(
                                    "kernel-grid", a, self.qualname,
                                    f"magic number {n} passed to "
                                    f"`{node.func.attr}` — tie launch "
                                    f"geometry to named constants or the "
                                    f"C planner so it stays auditable")
                self.generic_visit(node)

        V().visit(self.tree)

    # kernel-test ----------------------------------------------------------
    def _check_kernel_test(self) -> None:
        if not self._kernel:
            return
        defs = {n.name for n in self.tree.body
                if isinstance(n, ast.FunctionDef)}
        for node in self.tree.body:
            if not isinstance(node, ast.FunctionDef) or \
                    node.name.startswith("_"):
                continue
            if not any(isinstance(n, ast.Call)
                       and _dotted(n.func) == _LIBRARY_LOADER
                       for n in ast.walk(node)):
                continue
            name = node.name
            if f"{name}_plain" not in defs:
                self._emit(
                    "kernel-test", node, name,
                    f"kernel wrapper `{name}` has no `{name}_plain` beside "
                    f"it — the CPU has nothing to run and the card nothing "
                    f"to hold the kernel to")
            word = re.compile(rf"\b{re.escape(name)}\b")
            if self.tests_blob and not word.search(self.tests_blob):
                self._emit(
                    "kernel-test", node, name,
                    f"kernel wrapper `{name}` is not referenced by any "
                    f"file under the tests directory — add a test against "
                    f"its plain version")
            if self.smoke_blob and not word.search(self.smoke_blob):
                self._emit(
                    "kernel-test", node, name,
                    f"kernel wrapper `{name}` is not driven by "
                    f"chip_smoke.py — the card never holds it to its "
                    f"plain version")


# -- entry points ---------------------------------------------------------------
def _read_tests_blob(tests_dir: Optional[str]) -> str:
    if not tests_dir or not os.path.isdir(tests_dir):
        return ""
    chunks = []
    for base, _dirs, files in os.walk(tests_dir):
        for f in sorted(files):
            if f.endswith(".py"):
                p = os.path.join(base, f)
                try:
                    with open(p, encoding="utf-8") as fh:
                        chunks.append(fh.read())
                except OSError:
                    pass
    return "\n".join(chunks)


def _read_smoke_blob(smoke_file: Optional[str]) -> str:
    if not smoke_file or not os.path.isfile(smoke_file):
        return ""
    with open(smoke_file, encoding="utf-8") as fh:
        return fh.read()


def analyze_file(path: str, config: Optional[LintConfig] = None,
                 rel: Optional[str] = None,
                 tests_blob: Optional[str] = None,
                 smoke_blob: Optional[str] = None,
                 suppressed: bool = False) -> List[Finding]:
    """Findings of one file; with ``suppressed``, the inline-disabled ones
    too (``Finding.suppressed`` set)."""
    config = config or LintConfig()
    if tests_blob is None:
        tests_blob = _read_tests_blob(config.tests_dir)
    if smoke_blob is None:
        smoke_blob = _read_smoke_blob(config.smoke_file)
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    out = _ModuleLinter(path, rel or path, source, config, tests_blob,
                        smoke_blob).run()
    return out if suppressed else [f for f in out if f.suppressed is None]


def _iter_py(root: str) -> Iterable[Tuple[str, str]]:
    """(abspath, relpath-for-fingerprints). Fingerprint paths are rooted
    at the scan root's basename so they are stable across machines and
    working directories (``repro_torch/…`` whether scanned as
    ``src/repro_torch`` or ``/abs/path/src/repro_torch``)."""
    root = root.rstrip(os.sep)
    if os.path.isfile(root):
        yield root, os.path.basename(root)
        return
    base = os.path.basename(os.path.abspath(root))
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__", ".git")]
        for f in sorted(files):
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                yield p, os.path.join(
                    base, os.path.relpath(p, root)).replace(os.sep, "/")


def analyze_paths(paths: Sequence[str],
                  config: Optional[LintConfig] = None,
                  suppressed: bool = False) -> List[Finding]:
    config = config or LintConfig()
    tests_blob = _read_tests_blob(config.tests_dir)
    smoke_blob = _read_smoke_blob(config.smoke_file)
    out: List[Finding] = []
    for root in paths:
        for path, rel in _iter_py(root):
            out.extend(analyze_file(path, config, rel=rel,
                                    tests_blob=tests_blob,
                                    smoke_blob=smoke_blob,
                                    suppressed=suppressed))
    return out
