"""The JAX package's static gates (tools/lint_*.py) over the port.

tests/test_static_analysis.py runs the lints on the JAX package's files.
Three of them read paths or declaration styles the port does not have, so
this file drives their parsers over the port's own files; the other two
run unchanged on a temp tree that holds the port's package where they
read the JAX one. Nothing under tools/ is edited.

- ABI: every ctypes declaration of the port against its native definition
  (``lint_abi.native_functions``): the ``_SIGNATURES`` tables of
  comm/transport.py, comm/engine.py and ops/codec_np.py (the last against
  native/stcodec.c, which JAX's lint never reads), the attribute-style
  declarations of shard/engine_lane.py (``lint_abi.py_declarations``) and
  the kernel wrappers' table of ops/codec_cuda.py (against csrc/*.cu):
  parameter counts and kinds (``lint_abi._compatible``), return types,
  ``outN`` buffer widths, the struct mirrors, the transport queue depth's
  three declarations and the shm family's two-way rule.
- Wire: the port's comm/wire.py constants against the native ones over
  ``lint_wire``'s own maps, the capability flags against the JAX package's
  compat.py, the transport's data-kind set and the RDATA header sizes.
- Events and locks: ``lint_events.run`` and ``lint_locks.run`` as they are.
- Metrics: ``lint_metrics.run``, where a quoted ``st_*`` name that is a
  native function (``lint_abi.native_functions`` over native/ and csrc/)
  is a ctypes symbol, not a metric.

Each gate is green on the tree and red, by name, on a violation seeded in
a temp copy, as the JAX package's negative tests are.
"""

import ast
import pathlib
import re
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import _lintlib as L  # noqa: E402
import lint_abi  # noqa: E402
import lint_events  # noqa: E402
import lint_locks  # noqa: E402
import lint_metrics  # noqa: E402
import lint_wire  # noqa: E402

PKG = "shared_tensor_tpu_torch"
#: the module-level ctypes tables, by file: (table name, its value's shape)
TABLES = {
    "comm/transport.py": ("_SIGNATURES", "restype+args"),
    "comm/engine.py": ("_SIGNATURES", "restype+args"),
    "ops/codec_np.py": ("_SIGNATURES", "args"),  # restype None throughout
    "ops/codec_cuda.py": ("_ARGTYPES", "symbol+args"),  # restype c_int throughout
}
ATTRIBUTE_DECLS = "shard/engine_lane.py"
#: every port file that calls into a native library (outN allocations)
CALLERS = ("comm/transport.py", "comm/engine.py", "ops/codec_np.py", "shard/engine_lane.py")
#: st_ literals of the port that are no metric and no native function
PORT_NON_METRICS = {
    "st_ctl": "the operator CLI's default command directory, JAX's name (ctl.py)",
    "st_mesh_": "the pod tier's temporary directory prefix (parallel/mesh.py)",
}

_NP_KIND = {"float32": "_f32p", "uint32": "_u32p", "uint64": "_u64p", "int32": "_i32p", "int64": "_i64p",
            "uint8": "_u8p", "float64": "ctypes.POINTER(ctypes.c_double)"}
_CTYPES_ALIAS = {"ctypes.c_longlong": "ctypes.c_int64", "ctypes.c_int": "ctypes.c_int32"}


def _tree(tmp_path: pathlib.Path) -> pathlib.Path:
    """A copy of what the gates read: native/ and the port (csrc/ sources
    included), and the port again as ``shared_tensor_tpu/``, the package
    path lint_events, lint_locks and lint_metrics read."""
    root = tmp_path / "repo"
    for ext in ("*.c", "*.cpp", "*.h"):
        for src in (REPO / "native").glob(ext):
            (root / "native").mkdir(parents=True, exist_ok=True)
            shutil.copy(src, root / "native" / src.name)
    for dst in (PKG, "shared_tensor_tpu"):
        for src in [*(REPO / PKG).rglob("*.py"), *(REPO / PKG / "csrc").glob("*.cu")]:
            out = root / dst / src.relative_to(REPO / PKG)
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, out)
    return root


def _edit(root: pathlib.Path, rel: str, old: str, new: str) -> None:
    p = root / rel
    text = p.read_text()
    assert old in text, f"seed-edit anchor missing from {rel}: {old!r}"
    p.write_text(text.replace(old, new, 1))


# -- the native side ----------------------------------------------------------------------------


def _native(root: pathlib.Path) -> dict[str, dict]:
    """lint_abi's parse of every native definition the port binds. Its
    pattern keys on the ``st_`` prefix, so stcodec.c's ``stc_*`` names are
    read as ``st_stc_*`` and given back their own; the CUDA sources' long
    long and pointer-to-pointer parameters are spelled as the parser knows
    them."""
    text = "".join(L.strip_c_comments(L.read(root, f"native/{f}")) for f in ("stengine.cpp", "sttransport.cpp"))
    nat = lint_abi.native_functions(text)
    codec = re.sub(r"\bstc_", "st_stc_", L.strip_c_comments(L.read(root, "native/stcodec.c")))
    nat.update({k[3:]: v for k, v in lint_abi.native_functions(codec).items() if k.startswith("st_stc_")})
    for cu in sorted((root / PKG / "csrc").glob("*.cu")):
        t = L.strip_c_comments(cu.read_text())
        t = re.sub(r"\blong long\b", "int64_t", t)
        t = re.sub(r"\w+\s*\*\s*const\s*\*|\bvoid\s*\*\s*\*", "st_ptrptr_t* ", t)
        for name, d in lint_abi.native_functions(t).items():
            nat[name] = {**d, "ret": "i32" if d["ret"] == "int" else d["ret"]}
    return nat


# -- the Python side ----------------------------------------------------------------------------


def _aliases(tree: ast.Module) -> dict[str, ast.expr]:
    """Module-level ``NAME = expr`` and ``A, B = x, y`` bindings."""
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        if isinstance(t, ast.Name):
            out[t.id] = v
        elif isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) and len(t.elts) == len(v.elts):
            out.update({n.id: e for n, e in zip(t.elts, v.elts) if isinstance(n, ast.Name)})
    return out


def _token(node: ast.expr, aliases: dict) -> str:
    """An argtype expression as the token ``lint_abi._py_kind`` reads."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return _token(aliases[node.id], aliases)
        return node.id
    if isinstance(node, ast.Call):
        fn = ast.unparse(node.func)
        if fn == "np.ctypeslib.ndpointer":
            return _NP_KIND.get(ast.unparse(node.args[0]).removeprefix("np."), f"unparsed:{ast.unparse(node)}")
        if fn == "ctypes.POINTER":
            inner = _token(node.args[0], aliases)
            return "st_ptrptr" if inner == "ctypes.c_void_p" else f"ctypes.POINTER({inner})"
    tok = ast.unparse(node)
    return _CTYPES_ALIAS.get(tok, tok)


def _kind(tok: str) -> str:
    return "ptr:st_ptrptr_t" if tok == "st_ptrptr" else lint_abi._py_kind(tok)


def _table_decls(text: str, table: str, shape: str) -> dict[str, dict]:
    tree = ast.parse(text)
    aliases = _aliases(tree)
    node = aliases.get(table)
    assert isinstance(node, ast.Dict), f"no module-level dict {table}"
    out = {}
    for key, val in zip(node.keys, node.values):
        if shape == "symbol+args":
            sym, args = val.elts
            name, ret = sym.value, "i32"
        elif shape == "restype+args":
            (res, args), name = val.elts, key.value
            ret = _kind(_token(res, aliases))
        else:
            args, name, ret = val, key.value, "void"
        out[name] = {"ret": ret, "params": [_kind(_token(a, aliases)) for a in args.elts]}
    return out


def _declarations(root: pathlib.Path) -> dict[str, tuple[str, dict]]:
    """name -> (file, {ret, params}) over the port's declaration sites."""
    out = {}
    for rel, (table, shape) in TABLES.items():
        for name, d in _table_decls(L.read(root, f"{PKG}/{rel}"), table, shape).items():
            out[name] = (rel, d)
    text = L.strip_py_comments(L.read(root, f"{PKG}/{ATTRIBUTE_DECLS}"))
    for name, d in lint_abi.py_declarations(text).items():
        out[name] = (ATTRIBUTE_DECLS, d)
    return out


def abi_findings(root: pathlib.Path) -> list[str]:
    findings = []
    nat = _native(root)
    py = _declarations(root)
    per_file = {rel: sum(1 for f, _ in py.values() if f == rel) for rel in [*TABLES, ATTRIBUTE_DECLS]}
    for rel, n in per_file.items():
        if n < 3:
            findings.append(f"parse floor: only {n} declarations parsed in {rel} (pattern rot?)")
    for name, (rel, d) in sorted(py.items()):
        if name not in nat:
            findings.append(f"{rel} declares {name} but no native definition exists")
            continue
        nparams = [k for k, _ in nat[name]["params"]]
        if "params" in d:
            if len(d["params"]) != len(nparams):
                findings.append(f"{name}: argtypes count {len(d['params'])} != native parameter count "
                                f"{len(nparams)} ({rel})")
            else:
                for i, (pk, nk) in enumerate(zip(d["params"], nparams)):
                    if not lint_abi._compatible(pk, nk):
                        findings.append(f"{name}: param {i} type mismatch: ctypes {pk} vs native {nk} ({rel})")
        if "ret" in d and not lint_abi._compatible(d["ret"], nat[name]["ret"]):
            findings.append(f"{name}: restype {d['ret']} vs native return {nat[name]['ret']} ({rel})")
    # the outN widths: what the native body writes, and every port buffer
    # allocated for the call (the widening class of st_engine_counters)
    sources = {rel: L.strip_py_comments(L.read(root, f"{PKG}/{rel}")) for rel in CALLERS}
    for name, nd in sorted(nat.items()):
        for _, pname in nd["params"]:
            m = re.match(r"out(\d+)$", pname)
            if not m:
                continue
            width = int(m.group(1))
            idxs = [int(i) for i in re.findall(r"\b%s\[(\d+)\]" % pname, nd["body"])]
            if idxs and max(idxs) != width - 1:
                findings.append(f"{name}: native body writes {pname}[{max(idxs)}] but the parameter name "
                                f"promises exactly {width} slots")
            called = False
            for rel, text in sources.items():
                called |= bool(re.search(r"lib\.%s\(" % name, text))
                for alloc in re.findall(
                    r"(?:np\.(?:zeros|empty)\(\s*(\d+)|\(ctypes\.c_uint64 \* (\d+)\)\(\))"
                    r"(?:(?!def )[\s\S]){0,400}?lib\.%s\(" % name, text,
                ):
                    n = int(alloc[0] or alloc[1])
                    if n != width:
                        findings.append(f"{name}: {rel} allocates a {n}-slot buffer for the native "
                                        f"{width}-slot {pname}")
            if name in py and not called:
                findings.append(f"{name}: declared, but no call with its {pname} buffer found (pattern rot?)")
    # the shm lane's entry points must be declared both ways
    for name in sorted(nat):
        if name.startswith("st_node_shm_") and name not in py:
            findings.append(f"{name}: native definition exists but no port ctypes declaration does; the shm "
                            f"lane would silently never negotiate (bidirectional-family rule)")
    if not any(n.startswith("st_node_shm_") for n in nat):
        findings.append("parse floor: no native st_node_shm_* definitions found")
    # the transport queue depth, declared three times
    t_nat = L.strip_c_comments(L.read(root, "native/sttransport.cpp"))
    depths = {}
    m = re.search(r"int32_t\s+queue_depth\s*=\s*(\d+)\s*;", t_nat)
    if m:
        depths["sttransport.cpp queue_depth"] = int(m.group(1))
    m = re.search(r"queue_depth:\s*int\s*=\s*(\d+)", sources["comm/transport.py"])
    if m:
        depths["transport.py queue_depth default"] = int(m.group(1))
    m = re.search(r"^QUEUE_DEPTH\s*=\s*(\d+)", L.read(root, f"{PKG}/shard/node.py"), re.M)
    if m:
        depths["shard/node.py QUEUE_DEPTH"] = int(m.group(1))
    if len(depths) != 3 or len(set(depths.values())) != 1:
        findings.append(f"queue-depth drift (or pattern rot): {depths}")
    # the ctypes.Structure mirrors
    t_py = sources["comm/transport.py"]
    for sname in ("StConfigC", "StEventC", "StStatsC"):
        nf, pf = lint_abi._struct_fields_native(t_nat, sname), lint_abi._struct_fields_py(t_py, "_" + sname)
        if not nf or not pf:
            findings.append(f"{sname}: struct parse failed (pattern rot?)")
        elif nf != pf:
            findings.append(f"{sname}: field layout drifted: native {nf} vs ctypes {pf}")
    return findings


# -- wire ---------------------------------------------------------------------------------------


def _int_literals(text: str) -> set[int]:
    return {n.value for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Constant) and type(n.value) is int}


def wire_findings(root: pathlib.Path) -> list[str]:
    findings = []
    engine = L.strip_c_comments(L.read(root, "native/stengine.cpp"))
    transport = L.strip_c_comments(L.read(root, "native/sttransport.cpp"))
    nat, tnat = lint_wire._native_constants(engine), lint_wire._native_constants(transport)
    py = lint_wire._py_constants(L.strip_py_comments(L.read(root, f"{PKG}/comm/wire.py")))
    jax_compat = lint_wire._py_constants(L.strip_py_comments(L.read(REPO, "shared_tensor_tpu/compat.py")))
    port_sources = {str(p.relative_to(root)): p.read_text() for p in sorted((root / PKG).rglob("*.py"))}
    for cname, pyname in lint_wire.NATIVE_TO_WIRE.items():
        if cname not in nat:
            findings.append(f"stengine.cpp no longer defines {cname}")
        elif pyname not in py:
            findings.append(f"the port's comm/wire.py does not define {pyname} ({cname})")
        elif nat[cname] != py[pyname]:
            findings.append(f"kind/size mismatch: stengine.cpp {cname}={nat[cname]} vs wire.py {pyname}={py[pyname]}")
    for cname, pyname in lint_wire.TRANSPORT_TO_WIRE.items():
        if cname not in tnat:
            findings.append(f"sttransport.cpp no longer defines {cname}")
        elif pyname in py:  # mirrored: it must be equal
            if tnat[cname] != py[pyname]:
                findings.append(f"size mismatch: sttransport.cpp {cname}={tnat[cname]} vs wire.py "
                                f"{pyname}={py[pyname]}")
        else:
            # not mirrored: no port module may build on it. A small value
            # (kCoalesce's 16) cannot be told from other uses of the
            # number, so the names are what is checked there
            names = (pyname, cname) + (("sendmmsg",) if cname == "kCoalesce" else ())
            for rel, text in port_sources.items():
                hits = [n for n in names if n in text]
                if tnat[cname] > 0xFFFF and tnat[cname] in _int_literals(text):
                    hits.append(hex(tnat[cname]))
                if hits:
                    findings.append(f"{rel} uses {cname} ({', '.join(hits)}) which comm/wire.py does not "
                                    f"mirror as {pyname}: mirror it there")
    for name in ("SYNC_FLAG_READ_ONLY", "SYNC_FLAG_RANGE", "SYNC_FLAG_SIGN2", "SYNC_FLAG_SHM", "SYNC_FLAG_SHARD"):
        if py.get(name) is None or py.get(name) != jax_compat.get(name):
            findings.append(f"capability flag {name}: wire.py {py.get(name)} vs the JAX package's compat.py "
                            f"{jax_compat.get(name)}")
    if py.get("SHM_FLAG") != py.get("SYNC_FLAG_SHM"):
        findings.append(f"SHM hello flag drift: wire.py SHM_FLAG={py.get('SHM_FLAG')} vs SYNC_FLAG_SHM="
                        f"{py.get('SYNC_FLAG_SHM')}")
    jax_bits = {v for k, v in jax_compat.items() if k.startswith("SYNC_FLAG_")}
    own = py.get("SYNC_FLAG_PREV_LINK")
    if own is None or any(own & b for b in jax_bits):
        findings.append(f"SYNC_FLAG_PREV_LINK={own} must be a bit no JAX flag uses ({sorted(jax_bits)})")
    m = re.search(r"bool\s+is_data\s*=(.*?);", transport, flags=re.S)
    lits = {int(v) for v in re.findall(r"kind0\s*==\s*(\d+)", m.group(1))} if m else None
    want = {py.get("DATA"), py.get("BURST"), py.get("RDATA"), py.get("FWD")}
    if lits != want:
        findings.append(f"sttransport.cpp is_data kind set {lits} != the port's data kinds {want}")
    m = re.search(r"hdr\s*=\s*e->trace_wire\s*\?\s*(\d+)\s*:\s*(\d+)", engine)
    if not m or (int(m.group(1)), int(m.group(2))) != (py.get("RDATA_HDR_T"), py.get("RDATA_HDR")):
        findings.append(f"RDATA header sizes: stengine.cpp {m and m.groups()} vs wire.py "
                        f"({py.get('RDATA_HDR_T')}, {py.get('RDATA_HDR')})")
    return findings


# -- metrics ------------------------------------------------------------------------------------


def metrics_findings(root: pathlib.Path) -> list[str]:
    """lint_metrics over the port, less its findings on names that are
    native functions (ctypes symbols the port binds by string) and on the
    two named non-metrics."""
    symbols = set(_native(root))
    out = []
    for f in lint_metrics.run(root):
        m = re.match(r"undocumented metric name '(st_\w+)'", f)
        if m and (m.group(1) in symbols or m.group(1) in PORT_NON_METRICS):
            continue
        out.append(f)
    return out


# -- green on the tree --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("port_lints"))


@pytest.mark.parametrize("gate", ["abi", "wire", "events", "locks", "metrics"])
def test_gate_green_on_the_port(tree, gate):
    run = {"abi": abi_findings, "wire": wire_findings, "events": lint_events.run, "locks": lint_locks.run,
           "metrics": metrics_findings}[gate]
    findings = run(tree)
    assert findings == [], findings


def test_abi_gate_reads_every_declaration_site(tree):
    """Each site is parsed and checked: the tables, the attribute-style
    declarations, stcodec.c's functions and the CUDA wrappers'."""
    py, nat = _declarations(tree), _native(tree)
    files = {rel for rel, _ in py.values()}
    assert files == {*TABLES, ATTRIBUTE_DECLS}
    assert {"stc_apply_frames", "stc_quantize2_ef_cascade", "st_quantize_rows", "st_apply_rows_batch",
            "st_engine_counters", "st_shard_counters", "st_node_shm_join"} <= set(py)
    assert all(name in nat for name in py)
    assert len(py) >= 80


def test_port_non_metrics_are_still_emitted(tree):
    """The two exclusions name literals the port still has (a stale entry
    would hide nothing but must go)."""
    pat = re.compile(r"""["'](st_[a-z0-9_]+)["']""")
    emitted = {n for p in (tree / PKG).rglob("*.py") for n in pat.findall(p.read_text())}
    assert set(PORT_NON_METRICS) <= emitted


# -- red on seeded violations -------------------------------------------------------------------

ABI_SEEDS = {
    "dropped_argtype": (
        "comm/engine.py", '"st_engine_attach": (_I32, [_VP, _I32, _VP, _I32, ctypes.c_uint64]),',
        '"st_engine_attach": (_I32, [_VP, _I32, _VP, _I32]),', ("st_engine_attach", "count")),
    "narrowed_counter_buffer": (
        "comm/engine.py", "out = np.zeros(22, np.uint64)", "out = np.zeros(18, np.uint64)",
        ("st_engine_counters", "18")),
    "retyped_struct_field": (
        "comm/transport.py", '("bandwidth_cap_bps", ctypes.c_int64)', '("bandwidth_cap_bps", ctypes.c_int32)',
        ("StConfigC", "drifted")),
    "dropped_shm_declaration": (
        "comm/transport.py", '"st_node_shm_join": ', '"st_node_shm_join_x": ', ("st_node_shm_join", "bidirectional")),
    "codec_np_arity": (
        "ops/codec_np.py", '"stc_apply_frame": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _f32p, _u32p],',
        '"stc_apply_frame": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _f32p],', ("stc_apply_frame", "count")),
    "engine_lane_arity": (
        "shard/engine_lane.py",
        "lib.st_shard_member_attach.argtypes = [\n"
        "        ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint64,",
        "lib.st_shard_member_attach.argtypes = [\n        ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64,",
        ("st_shard_member_attach", "count")),
    "kernel_wrapper_retyped": (
        "ops/codec_cuda.py", '"quantize_rows": ("st_quantize_rows", [_VP, _VP, _VP, _VP, _I64, _VP]),',
        '"quantize_rows": ("st_quantize_rows", [_VP, _VP, _VP, _VP, _I32, _VP]),', ("st_quantize_rows", "param 4")),
    "finish_kernel_arity": (
        "ops/codec_cuda.py", "[_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _VP]),",
        "[_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32, _I32, _VP]),", ("st_cascade_round", "count")),
    "cascade_partials_retyped": (
        "ops/codec_cuda.py", "[_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _VP]),",
        "[_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I64, _I32, _I32, _I32, _VP]),",
        ("st_quantize_rows_cascade", "param 7")),
}


@pytest.mark.parametrize("seed", sorted(ABI_SEEDS))
def test_abi_gate_flags_seeded_violation(tmp_path, seed):
    rel, old, new, names = ABI_SEEDS[seed]
    root = _tree(tmp_path)
    _edit(root, f"{PKG}/{rel}", old, new)
    findings = abi_findings(root)
    assert any(all(n in f for n in names) for f in findings), findings


def test_wire_gate_flags_renumbered_kind(tmp_path):
    root = _tree(tmp_path)
    _edit(root, f"{PKG}/comm/wire.py", "\nACK = 6\n", "\nACK = 5\n")
    findings = wire_findings(root)
    assert any("kAck" in f and "ACK" in f for f in findings), findings


def test_wire_gate_flags_an_unmirrored_constant_in_use(tmp_path):
    """The shm SWITCH marker's length used in a port module without a
    mirror in wire.py is a finding; mirrored wrongly, another."""
    root = _tree(tmp_path)
    _edit(root, f"{PKG}/comm/transport.py", "_lib: Optional[ctypes.CDLL] = None",
          "_SWITCH = 0xFFFFFFFD\n_lib: Optional[ctypes.CDLL] = None")
    findings = wire_findings(root)
    assert any("comm/transport.py uses kShmSwitchLen" in f for f in findings), findings
    _edit(root, f"{PKG}/comm/wire.py", "\nDATA = 0\n", "\nDATA = 0\nSHM_SWITCH_LEN = 0xFFFFFFFE\n")
    findings = wire_findings(root)
    assert any("kShmSwitchLen" in f and "SHM_SWITCH_LEN" in f and "mismatch" in f for f in findings), findings


def test_wire_gate_flags_a_colliding_port_flag(tmp_path):
    root = _tree(tmp_path)
    _edit(root, f"{PKG}/comm/wire.py", "SYNC_FLAG_PREV_LINK = 0x20", "SYNC_FLAG_PREV_LINK = 0x10")
    findings = wire_findings(root)
    assert any("SYNC_FLAG_PREV_LINK" in f for f in findings), findings


def test_events_lint_flags_renamed_shm_event(tmp_path):
    root = _tree(tmp_path)
    _edit(root, "shared_tensor_tpu/obs/events.py", '34: "shm_lane_up"', '34: "shm_lane_went_up"')
    findings = lint_events.run(root)
    assert any("shm_lane_up" in f for f in findings), findings


def test_locks_lint_flags_blocking_send_under_ledger_lock(tmp_path):
    """The port peer's ledger lock with a blocking send under it: the
    receive thread pops ACKs under the same lock."""
    root = _tree(tmp_path)
    _edit(root, "shared_tensor_tpu/comm/peer.py",
          "with self._ack_mu:\n                msgs_out = sum(self._acked.values())",
          "with self._ack_mu:\n                self._send_blocking(1, b'x')\n"
          "                msgs_out = sum(self._acked.values())")
    findings = lint_locks.run(root)
    assert any("_send_blocking" in f and "_ack_mu" in f and "comm/peer.py" in f for f in findings), findings


def test_metrics_gate_flags_undocumented_name(tmp_path):
    root = _tree(tmp_path)
    _edit(root, "shared_tensor_tpu/comm/peer.py", "    def metrics(",
          '    UNDOC = "st_totally_undocumented_metric"\n\n    def metrics(')
    findings = metrics_findings(root)
    assert any("st_totally_undocumented_metric" in f for f in findings), findings
