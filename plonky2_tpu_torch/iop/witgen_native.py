"""Native witness generation: trace generators into field-op bytecode,
run the fixpoint in C (native/witgen.c).

The reference runs witness generators as native Rust closures under a
worklist fixpoint (plonky2/src/iop/generator.rs:26-104). Python closures
made witness generation the dominant serial cost at scale, so this
module compiles each generator's ``run_once`` into a tiny register-quad
program over Goldilocks and executes the whole fixpoint in C:

* **Tracing**: ``run_once`` is executed once against a symbolic witness
  whose values are :class:`Sym` nodes. Arithmetic on a Sym emits a quad;
  the resulting program is POOLED per (generator type, non-row params),
  so ten thousand PoseidonGenerators share one traced program and only
  carry per-instance dep/output target indices.
* **Fail-safe by construction**: any operation whose traced semantics
  could diverge from the Python semantics (value comparisons, bool
  coercion, int()) raises :class:`TraceAbort`, and that generator type
  stays in Python. The only comparisons the tracer answers are ones the
  canonical-form invariant (0 <= v < P) decides: ``v >= P`` is False,
  ``v < 0`` is False.
* **Hand encoders** cover the generators whose run_once genuinely
  branches on witness values (InvOrZero/NonzeroTest via ISZERO+INV0,
  RandomAccess via PICK, Lookup via TBL, LookupTable/Constant/Copy as
  constant/copy programs).
* **Python bridge**: untraceable generators (RandomValueGenerator draws
  fresh randomness per prove; DummyProofGenerator proves a circuit) run
  in Python between C fixpoint rounds, their outputs fed back through
  ``witgen_set``.

Correctness is pinned by bit-equality of the full witness against the
pure-Python fixpoint across the circuit corpus
(tests/test_torch_native.py), and every set-twice conflict check the
Python path performs is preserved in the engine.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..field.goldilocks import P
from .target import Target
from .witness import PartitionWitness

# ---------------------------------------------------------------------------
# opcodes (must match native/witgen.c)

OP_LOADC, OP_LOADD, OP_ADD, OP_SUB, OP_MUL, OP_INV0, OP_EXPC = 1, 2, 3, 4, 5, 6, 7
OP_UDIVC, OP_UMODC, OP_PICK, OP_TBL, OP_OUT = 8, 9, 10, 11, 12

_ERR_NAMES = {
    -1: "set-twice conflict",
    -2: "lookup input not found in the LUT",
    -3: "random-access index out of range",
    -4: "bad opcode",
    -5: "out of memory",
    -6: "division by zero constant",
}


class TraceAbort(Exception):
    """Raised when run_once does something the tracer cannot compile
    faithfully; the generator type falls back to Python."""


# ---------------------------------------------------------------------------
# program builder + symbolic values


class _Prog:
    __slots__ = ("quads", "consts", "_cmap", "_creg", "nregs")

    def __init__(self):
        self.quads: List[Tuple[int, int, int, int, int]] = []
        self.consts: List[int] = []
        self._cmap: Dict[int, int] = {}
        self._creg: Dict[int, int] = {}
        self.nregs = 0

    def reg(self) -> int:
        r = self.nregs
        self.nregs += 1
        return r

    def cidx(self, v: int) -> int:
        v = int(v)
        assert 0 <= v < (1 << 64), f"constant out of u64 range: {v}"
        i = self._cmap.get(v)
        if i is None:
            i = len(self.consts)
            self.consts.append(v)
            self._cmap[v] = i
        return i

    def const_reg(self, v: int) -> int:
        """Register holding constant v (mod P), cached per program."""
        v = int(v) % P
        r = self._creg.get(v)
        if r is None:
            r = self.reg()
            self.emit(OP_LOADC, r, self.cidx(v))
            self._creg[v] = r
        return r

    def emit(self, op, dst, a=0, b=0, c=0) -> None:
        self.quads.append((op, dst, a, b, c))


class Sym:
    """A symbolic canonical Goldilocks value living in register ``r``."""

    __slots__ = ("p", "r")

    def __init__(self, p: _Prog, r: int):
        self.p = p
        self.r = r

    def _coerce(self, other) -> "Sym":
        if isinstance(other, Sym):
            if other.p is not self.p:
                raise TraceAbort("mixed programs")
            return other
        if isinstance(other, (int, np.integer)):
            return Sym(self.p, self.p.const_reg(int(other)))
        raise TraceAbort(f"cannot coerce {type(other)}")

    def _bin(self, op, other, swap=False) -> "Sym":
        o = self._coerce(other)
        d = self.p.reg()
        a, b = (o.r, self.r) if swap else (self.r, o.r)
        self.p.emit(op, d, a, b)
        return Sym(self.p, d)

    def __add__(self, o):
        return self._bin(OP_ADD, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(OP_SUB, o)

    def __rsub__(self, o):
        return self._bin(OP_SUB, o, swap=True)

    def __mul__(self, o):
        return self._bin(OP_MUL, o)

    __rmul__ = __mul__

    def __neg__(self):
        return Sym(self.p, self.p.const_reg(0))._bin(OP_SUB, self)

    def __mod__(self, m):
        if not isinstance(m, (int, np.integer)):
            raise TraceAbort("symbolic modulus")
        m = int(m)
        if m == P:
            return self  # values are canonical by construction
        if m <= 0:
            raise TraceAbort("non-positive modulus")
        d = self.p.reg()
        self.p.emit(OP_UMODC, d, self.r, self.p.cidx(m))
        return Sym(self.p, d)

    def __floordiv__(self, m):
        if not isinstance(m, (int, np.integer)) or int(m) <= 0:
            raise TraceAbort("symbolic or non-positive divisor")
        d = self.p.reg()
        self.p.emit(OP_UDIVC, d, self.r, self.p.cidx(int(m)))
        return Sym(self.p, d)

    def __and__(self, m):
        if not isinstance(m, (int, np.integer)):
            raise TraceAbort("symbolic mask")
        m = int(m)
        if m < 0 or (m + 1) & m:
            raise TraceAbort("mask is not 2^n - 1")
        return self % (m + 1)

    def __rshift__(self, n):
        if not isinstance(n, (int, np.integer)) or int(n) < 0:
            raise TraceAbort("symbolic shift")
        return self // (1 << int(n))

    def __pow__(self, e, mod=None):
        if mod != P or not isinstance(e, (int, np.integer)) or int(e) < 0:
            raise TraceAbort("pow without mod P")
        e = int(e)
        d = self.p.reg()
        if e == P - 2:
            self.p.emit(OP_INV0, d, self.r)
        else:
            self.p.emit(OP_EXPC, d, self.r, self.p.cidx(e))
        return Sym(self.p, d)

    # --- comparisons: only canonical-form-decidable ones are answered ---
    def __ge__(self, o):
        if isinstance(o, (int, np.integer)) and int(o) >= P:
            return False  # canonical values are < P
        raise TraceAbort("data-dependent >=")

    def __lt__(self, o):
        if isinstance(o, (int, np.integer)) and int(o) <= 0:
            return False  # canonical values are >= 0
        raise TraceAbort("data-dependent <")

    def __gt__(self, o):
        raise TraceAbort("data-dependent >")

    def __le__(self, o):
        raise TraceAbort("data-dependent <=")

    def __eq__(self, o):
        raise TraceAbort("data-dependent ==")

    def __ne__(self, o):
        raise TraceAbort("data-dependent !=")

    def __hash__(self):
        raise TraceAbort("hashing a symbolic value")

    def __bool__(self):
        raise TraceAbort("bool() of a symbolic value")

    def __int__(self):
        raise TraceAbort("int() of a symbolic value")

    __index__ = __int__


class _TraceWitness:
    """Witness stand-in: every get_target returns a Sym dep leaf."""

    def __init__(self, prog: _Prog):
        self.prog = prog
        self.dep_targets: List[Target] = []
        self._syms: Dict[Target, Sym] = {}

    def get_target(self, t: Target) -> Sym:
        s = self._syms.get(t)
        if s is None:
            slot = len(self.dep_targets)
            self.dep_targets.append(t)
            r = self.prog.reg()
            self.prog.emit(OP_LOADD, r, slot)
            s = Sym(self.prog, r)
            self._syms[t] = s
        return s

    def get_targets(self, ts) -> List[Sym]:
        return [self.get_target(t) for t in ts]

    def try_get_target(self, t):
        raise TraceAbort("try_get_target is value-dependent")

    def contains(self, t) -> bool:
        raise TraceAbort("contains() is value-dependent")


class _TraceOut:
    def __init__(self):
        self.outs: List[Tuple[Target, object]] = []

    def set_target(self, t: Target, v) -> None:
        self.outs.append((t, v))

    def set_wire(self, row: int, column: int, v) -> None:
        self.set_target(Target.wire(row, column), v)


@dataclasses.dataclass
class _Encoded:
    """One traced/hand-built program plus its symbolic dep/out targets."""

    prog: _Prog
    dep_targets: List[Target]
    out_targets: List[Target]


def _finish(prog: _Prog, tw_deps: List[Target], outs) -> _Encoded:
    out_targets = []
    for oi, (t, v) in enumerate(outs):
        if isinstance(v, Sym):
            r = v.r
        elif isinstance(v, (int, np.integer)):
            r = prog.const_reg(int(v) % P)
        else:
            raise TraceAbort(f"non-scalar output {type(v)}")
        prog.emit(OP_OUT, 0, oi, r)
        out_targets.append(t)
    return _Encoded(prog, tw_deps, out_targets)


def trace_generator(gen) -> _Encoded:
    prog = _Prog()
    tw = _TraceWitness(prog)
    to = _TraceOut()
    gen.run_once(tw, to)
    if not to.outs:
        raise TraceAbort("generator produced no outputs")
    return _finish(prog, tw.dep_targets, to.outs)


# ---------------------------------------------------------------------------
# hand encoders for value-branching generators


def _enc_constant(gen) -> _Encoded:
    prog = _Prog()
    r = prog.const_reg(gen.constant % P)
    prog.emit(OP_OUT, 0, 0, r)
    return _Encoded(prog, [], [Target.wire(gen.row, gen.wire_index)])


def _enc_copy(gen) -> _Encoded:
    prog = _Prog()
    r = prog.reg()
    prog.emit(OP_LOADD, r, 0)
    prog.emit(OP_OUT, 0, 0, r)
    return _Encoded(prog, [gen.src], [gen.dst])


def _enc_inv_or_zero(gen) -> _Encoded:
    # inv = d^-1 (0 -> 0); eq = [d == 0]  (ISZERO is not traceable)
    prog = _Prog()
    d = prog.reg()
    prog.emit(OP_LOADD, d, 0)
    inv = prog.reg()
    prog.emit(OP_INV0, inv, d)
    # eq = 1 - d * inv  (d != 0 -> 1 - 1 = 0; d == 0 -> 1 - 0 = 1)
    one = prog.const_reg(1)
    dinv = prog.reg()
    prog.emit(OP_MUL, dinv, d, inv)
    eq = prog.reg()
    prog.emit(OP_SUB, eq, one, dinv)
    prog.emit(OP_OUT, 0, 0, inv)
    prog.emit(OP_OUT, 0, 1, eq)
    return _Encoded(prog, [gen.diff], [gen.inv, gen.eq])


def _enc_nonzero_test(gen) -> _Encoded:
    # dummy = v == 0 ? 1 : v^-1  ==  inv0(v) + (1 - v*inv0(v))
    prog = _Prog()
    v = prog.reg()
    prog.emit(OP_LOADD, v, 0)
    inv = prog.reg()
    prog.emit(OP_INV0, inv, v)
    vinv = prog.reg()
    prog.emit(OP_MUL, vinv, v, inv)
    isz = prog.reg()
    prog.emit(OP_SUB, isz, prog.const_reg(1), vinv)
    res = prog.reg()
    prog.emit(OP_ADD, res, inv, isz)
    prog.emit(OP_OUT, 0, 0, res)
    return _Encoded(prog, [gen.to_test], [gen.dummy])


def _enc_random_access(gen) -> _Encoded:
    g = gen._gate()
    prog = _Prog()
    row = gen.row
    deps = [Target.wire(row, g.wire_access_index(gen.copy))]
    vec = g.vec_size()
    deps += [Target.wire(row, g.wire_list_item(i, gen.copy)) for i in range(vec)]
    idx = prog.reg()
    prog.emit(OP_LOADD, idx, 0)
    el = prog.reg()
    prog.emit(OP_PICK, el, 1, idx, vec)
    outs = [(Target.wire(row, g.wire_claimed_element(gen.copy)), Sym(prog, el))]
    cur = Sym(prog, idx)
    for i in range(gen.bits):
        outs.append((Target.wire(row, g.wire_bit(i, gen.copy)), cur % 2))
        cur = cur // 2
    return _finish(prog, deps, outs)


def _enc_lookup(gen) -> _Encoded:
    from ..gates.lookup import LookupGate

    prog = _Prog()
    inp = prog.reg()
    prog.emit(OP_LOADD, inp, 0)
    # table pairs go verbatim into the const pool (first match wins in C,
    # matching the Python scan)
    base = len(prog.consts)
    for i, o in gen.lut:
        # inputs stay raw (the C scan, like the Python one, compares the
        # looked-up wire against the raw table input); outputs are reduced
        # % P because OP_OUT writes verbatim while the Python path's
        # set_target canonicalizes
        prog.consts.append(int(i))
        prog.consts.append(int(o) % P)
    prog._cmap.clear()  # pairs alias the dedup map; disable further dedup
    res = prog.reg()
    prog.emit(OP_TBL, res, inp, base, len(gen.lut))
    prog.emit(OP_OUT, 0, 0, res)
    return _Encoded(
        prog,
        [Target.wire(gen.row, LookupGate.wire_ith_looking_inp(gen.slot_nb))],
        [Target.wire(gen.row, LookupGate.wire_ith_looking_out(gen.slot_nb))],
    )


def _enc_lookup_table(gen) -> _Encoded:
    from ..gates.lookup import LookupTableGate

    first_row = (
        gen.last_lut_row + (len(gen.lut) + gen.num_slots - 1) // gen.num_slots - 1
    )
    slot = (first_row - gen.row) * gen.num_slots + gen.slot_nb
    i, o = gen.lut[slot] if slot < len(gen.lut) else gen.lut[0]
    prog = _Prog()
    prog.emit(OP_OUT, 0, 0, prog.const_reg(int(i)))
    prog.emit(OP_OUT, 0, 1, prog.const_reg(int(o)))
    return _Encoded(
        prog,
        [],
        [
            Target.wire(gen.row, LookupTableGate.wire_ith_looked_inp(gen.slot_nb)),
            Target.wire(gen.row, LookupTableGate.wire_ith_looked_out(gen.slot_nb)),
        ],
    )


_HAND_ENCODERS = {
    "ConstantGenerator": _enc_constant,
    "CopyGenerator": _enc_copy,
    "InvOrZeroGenerator": _enc_inv_or_zero,
    "NonzeroTestGenerator": _enc_nonzero_test,
    "RandomAccessGenerator": _enc_random_access,
    "LookupGenerator": _enc_lookup,
    "LookupTableGenerator": _enc_lookup_table,
}

# Generators that must stay in Python: fresh randomness per prove, or
# arbitrarily complex host work (an inner prove).
_PYTHON_ONLY = {"RandomValueGenerator", "DummyProofGenerator"}


# ---------------------------------------------------------------------------
# per-circuit encoding (cached on prover_data)


def _pool_key(gen):
    """Pooling key: type + non-row scalar params; None = not poolable."""
    if not dataclasses.is_dataclass(gen):
        return None
    vals = []
    for f in dataclasses.fields(gen):
        if f.name == "row":
            continue
        v = getattr(gen, f.name)
        if isinstance(v, (int, str, bool)):
            vals.append((f.name, v))
        else:
            return None  # targets / lists / tables: per-instance
    return (type(gen).__name__, tuple(vals))


class _Encoding:
    """Flat arrays the C engine consumes, plus the Python-only leftovers."""

    __slots__ = (
        "gen_prog", "dep_off", "dep_flat", "out_off", "out_flat",
        "quad_off", "quads", "const_off", "consts", "nregs",
        "python_gens", "n_progs", "stats",
    )


def encode_circuit(prover_data, common) -> _Encoding:
    gens = prover_data.generators
    num_wires = common.config.num_wires
    degree = common.degree

    progs: List[_Prog] = []
    pool: Dict[object, Tuple[int, List[int], List[int], int]] = {}
    failed_types: Dict[str, str] = {}

    gen_prog = np.full(len(gens), -1, np.int32)
    dep_lists: List[List[int]] = []
    out_lists: List[List[int]] = []
    python_gens: List[int] = []

    def flat(t: Target) -> int:
        return t.flat_index(num_wires, degree)

    def add_prog(enc: _Encoded) -> int:
        progs.append(enc.prog)
        return len(progs) - 1

    for gi, gen in enumerate(gens):
        name = type(gen).__name__
        deps_out: Optional[Tuple[int, List[int], List[int]]] = None
        if name in _PYTHON_ONLY or name in failed_types:
            pass
        else:
            key = _pool_key(gen)
            if key is not None and key in pool:
                pid, dep_cols, out_cols, row0 = pool[key]
                base = gen.row * num_wires
                deps_out = (
                    pid,
                    [base + c for c in dep_cols],
                    [base + c for c in out_cols],
                )
            else:
                enc = None
                try:
                    handler = _HAND_ENCODERS.get(name)
                    enc = handler(gen) if handler else trace_generator(gen)
                except TraceAbort as e:
                    failed_types[name] = str(e)
                except Exception as e:  # any trace explosion -> python path
                    failed_types[name] = f"{type(e).__name__}: {e}"
                if enc is not None:
                    pid = add_prog(enc)
                    deps_out = (
                        pid,
                        [flat(t) for t in enc.dep_targets],
                        [flat(t) for t in enc.out_targets],
                    )
                    if key is not None:
                        # poolable iff every target is a wire on gen.row
                        row = gen.row
                        ts = enc.dep_targets + enc.out_targets
                        if all(t.kind == "wire" and t.row == row for t in ts):
                            pool[key] = (
                                pid,
                                [t.column for t in enc.dep_targets],
                                [t.column for t in enc.out_targets],
                                row,
                            )
        if deps_out is None:
            python_gens.append(gi)
            dep_lists.append([])
            out_lists.append([])
        else:
            gen_prog[gi] = deps_out[0]
            dep_lists.append(deps_out[1])
            out_lists.append(deps_out[2])

    e = _Encoding()
    e.gen_prog = gen_prog
    e.dep_off = np.zeros(len(gens) + 1, np.int64)
    np.cumsum([len(d) for d in dep_lists], out=e.dep_off[1:])
    e.dep_flat = np.fromiter(
        (x for d in dep_lists for x in d), np.int64, count=int(e.dep_off[-1])
    )
    e.out_off = np.zeros(len(gens) + 1, np.int64)
    np.cumsum([len(o) for o in out_lists], out=e.out_off[1:])
    e.out_flat = np.fromiter(
        (x for o in out_lists for x in o), np.int64, count=int(e.out_off[-1])
    )
    e.n_progs = len(progs)
    e.quad_off = np.zeros(len(progs) + 1, np.int64)
    np.cumsum([len(p.quads) for p in progs], out=e.quad_off[1:])
    e.quads = np.fromiter(
        (v for p in progs for q in p.quads for v in q),
        np.int32,
        count=int(e.quad_off[-1]) * 5,
    )
    e.const_off = np.zeros(len(progs) + 1, np.int64)
    np.cumsum([len(p.consts) for p in progs], out=e.const_off[1:])
    e.consts = np.fromiter(
        (c for p in progs for c in p.consts), np.uint64, count=int(e.const_off[-1])
    )
    e.nregs = np.fromiter((max(p.nregs, 1) for p in progs), np.int32, count=len(progs))
    e.python_gens = python_gens
    e.stats = {
        "native_gens": int((gen_prog >= 0).sum()),
        "python_gens": len(python_gens),
        "programs": len(progs),
        "quads": int(e.quad_off[-1]),
        "fallback_types": dict(failed_types),
    }
    return e


# ---------------------------------------------------------------------------
# ctypes bindings

def _so_path():
    """The engine's library under ``plonky2_tpu_torch/_build/``, named by a
    hash of native/witgen.c and built there at first use
    (native.build_shared); None when the compiler fails."""
    from ..native import HERE, build_shared

    return build_shared(HERE / "witgen.c", "witgen", "-O2")


_lib = None
_lock = threading.Lock()
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _so_path()
        if so is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _failed = True
            return None
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.witgen_new.restype = p
        lib.witgen_new.argtypes = [p, i64, i64, p, p, i64, p, p, p, p, p,
                                   i64, p, p, p, p, p]
        lib.witgen_run.restype = i64
        lib.witgen_run.argtypes = [p]
        lib.witgen_set.restype = i64
        lib.witgen_set.argtypes = [p, p, p, i64]
        lib.witgen_remaining.restype = i64
        lib.witgen_remaining.argtypes = [p]
        lib.witgen_err.argtypes = [p, p]
        lib.witgen_free.argtypes = [p]
        _lib = lib
        return _lib


def available() -> bool:
    # Default ON (with transparent Python fallback: any generator the
    # tracer cannot encode, or a missing/failed C toolchain, routes the
    # whole prove through the pure-Python fixpoint — see
    # iop/generator.py:generate_partial_witness). Bit-equality with the
    # Python path is pinned by tests/test_torch_native.py's corpus suite.
    # Set PLONKY2_TPU_NATIVE_WITGEN=0 to force the Python fixpoint.
    if os.environ.get("PLONKY2_TPU_NATIVE_WITGEN", "1") == "0":
        return False
    return _load() is not None


class NumpyPartitionWitness(PartitionWitness):
    """PartitionWitness over u64 value / u8 set-flag arrays (shared with
    the C engine — zero-copy handoff after the fixpoint)."""

    def __init__(self, representative_map, num_wires, degree, values_np, flags):
        self.representative_map = representative_map
        self.num_wires = num_wires
        self.degree = degree
        self.values_np = values_np
        self.flags = flags

    @property
    def values(self):  # compat view; avoid in hot paths
        return [
            int(v) if f else None for v, f in zip(self.values_np, self.flags)
        ]

    def try_get_target(self, t: Target):
        rep = self.rep_index(t)
        return int(self.values_np[rep]) if self.flags[rep] else None

    def set_target(self, t: Target, value: int) -> bool:
        value = int(value) % P
        rep = self.rep_index(t)
        if self.flags[rep]:
            old = int(self.values_np[rep])
            assert old == value, (
                f"Partition containing {t} was set twice with different values: "
                f"{old} != {value}"
            )
            return False
        self.values_np[rep] = value
        self.flags[rep] = 1
        return True

    def values_snapshot(self) -> np.ndarray:
        return np.where(self.flags.astype(bool), self.values_np, np.uint64(0))

    def get_wires_bulk(self, flat_indices: np.ndarray) -> np.ndarray:
        reps = self.rep_map_np()[flat_indices]
        assert self.flags[reps].all(), "get_wires_bulk: unset target"
        return self.values_np[reps]

    def set_wires_bulk(self, rows, cols, values) -> None:
        flat = np.asarray(rows, np.int64) * self.num_wires + np.asarray(cols, np.int64)
        reps = self.rep_map_np()[flat]
        vals = np.fromiter((int(v) % P for v in values), np.uint64, count=len(reps))
        already = self.flags[reps].astype(bool)
        if already.any():
            assert (self.values_np[reps[already]] == vals[already]).all(), (
                "set_wires_bulk: set twice with different values"
            )
        # duplicates within one call: same rep must carry the same value
        order = np.argsort(reps, kind="stable")
        sr, sv = reps[order], vals[order]
        dup = sr[1:] == sr[:-1]
        assert (sv[1:][dup] == sv[:-1][dup]).all(), (
            "set_wires_bulk: duplicate rep with conflicting values"
        )
        self.values_np[reps] = vals
        self.flags[reps] = 1

    def full_witness(self):
        from .witness import MatrixWitness

        rep = self.rep_map_np()[: self.degree * self.num_wires]
        wires = (
            self.values_snapshot()[rep]
            .reshape(self.degree, self.num_wires)
            .T.copy()
        )
        return MatrixWitness(wires)


def generate_partial_witness_native(inputs, prover_data, common):
    """C-engine replacement for generate_partial_witness; returns a
    NumpyPartitionWitness, or None when the native path is unavailable."""
    lib = _load()
    if lib is None:
        return None
    enc = getattr(prover_data, "_witgen_enc", None)
    if enc is None:
        enc = encode_circuit(prover_data, common)
        prover_data._witgen_enc = enc

    rep_map_list = prover_data.representative_map
    rep_map = getattr(prover_data, "_witgen_rep_np", None)
    if rep_map is None:
        rep_map = np.asarray(rep_map_list, dtype=np.int64)
        prover_data._witgen_rep_np = rep_map
    n_targets = len(rep_map)
    # one value slot per target index, matching PartitionWitness.values
    # (representatives index into the same-length array)
    n_reps = n_targets

    values = np.zeros(n_reps, np.uint64)
    flags = np.zeros(n_reps, np.uint8)

    num_wires = common.config.num_wires
    degree = common.degree

    def ptr(a):
        return a.ctypes.data if a.size else None

    h = lib.witgen_new(
        rep_map.ctypes.data, n_targets, n_reps,
        values.ctypes.data, flags.ctypes.data,
        len(enc.gen_prog), enc.gen_prog.ctypes.data,
        enc.dep_off.ctypes.data, ptr(enc.dep_flat),
        enc.out_off.ctypes.data, ptr(enc.out_flat),
        enc.n_progs, enc.quad_off.ctypes.data, ptr(enc.quads),
        enc.const_off.ctypes.data, ptr(enc.consts), ptr(enc.nregs),
    )
    if not h:
        return None
    try:
        def check(rc):
            if rc < 0:
                info = np.zeros(4, np.int64)
                lib.witgen_err(h, info.ctypes.data)
                raise AssertionError(
                    f"native witgen: {_ERR_NAMES.get(int(info[0]), info[0])} "
                    f"(generator {info[1]}, target/key {info[2]}, value {info[3]})"
                )

        # seed the PartialWitness inputs
        items = list(inputs.items())
        if items:
            reps = np.fromiter(
                (rep_map[t.flat_index(num_wires, degree)] for t, _ in items),
                np.int64, count=len(items),
            )
            vals = np.fromiter(
                (int(v) % P for _, v in items), np.uint64, count=len(items)
            )
            check(lib.witgen_set(h, reps.ctypes.data, vals.ctypes.data, len(items)))
        check(lib.witgen_run(h))

        witness = NumpyPartitionWitness(rep_map_list, num_wires, degree, values, flags)
        pending = list(enc.python_gens)
        if pending:
            from .generator import GeneratedValues

            while pending:
                progress = False
                still = []
                for gi in pending:
                    gen = prover_data.generators[gi]
                    buf = GeneratedValues()
                    if gen.run(witness, buf):
                        if buf.target_values:
                            reps = np.fromiter(
                                (
                                    rep_map[t.flat_index(num_wires, degree)]
                                    for t, _ in buf.target_values
                                ),
                                np.int64, count=len(buf.target_values),
                            )
                            vals = np.fromiter(
                                (int(v) % P for _, v in buf.target_values),
                                np.uint64, count=len(buf.target_values),
                            )
                            check(
                                lib.witgen_set(
                                    h, reps.ctypes.data, vals.ctypes.data, len(reps)
                                )
                            )
                        progress = True
                    else:
                        still.append(gi)
                check(lib.witgen_run(h))
                pending = still
                if not progress:
                    break

        left = lib.witgen_remaining(h) + len(pending)
        if left:
            raise RuntimeError(f"{left} generators never ran (missing inputs?)")
        return witness
    finally:
        lib.witgen_free(h)
