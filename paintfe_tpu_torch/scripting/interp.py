"""Tree-walking evaluator with Rhai value semantics.

Matches the engine limits and numeric behavior the reference configures
(src/ops/scripting.rs:284-317): 50M-operation budget, i64/f64 arithmetic,
integer division truncates toward zero, division by zero is a runtime error.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from paintfe_tpu_torch.scripting.rhai_ast import parse

MAX_OPERATIONS = 50_000_000
MAX_CALL_DEPTH = 64

UNIT = object()  # Rhai's ()


class RhaiRuntimeError(Exception):
    def __init__(self, message):
        super().__init__(message)
        self.message = message


class RhaiSystemError(RhaiRuntimeError):
    """Non-catchable engine errors (operation budget, call depth,
    cancellation) — Rhai's try/catch does not intercept system errors."""


class _Throw(Exception):
    """A Rhai `throw` in flight; carries the thrown Dynamic value."""

    def __init__(self, value):
        super().__init__(to_display(value) if not isinstance(value, str) else value)
        self.value = value


class _Break(Exception):
    """`break` / `break value` — the value becomes the result of the
    enclosing loop expression (None here means unit)."""

    def __init__(self, value=None):
        self.value = value


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def _rhai_copy(v):
    """Rhai value semantics: arrays and maps are values — `let t = log`,
    assignments, and function-argument binding all clone (the reference
    embeds Rhai 1.25, where Dynamic is clone-on-assign).  Scalars,
    strings, closures, and host arrays pass through."""
    if isinstance(v, list):
        return [_rhai_copy(x) for x in v]
    if isinstance(v, dict):
        return {k: _rhai_copy(x) for k, x in v.items()}
    return v


class Closure:
    def __init__(self, params, body, scope_chain):
        self.params = params
        self.body = body
        self.scope_chain = scope_chain


class FnPtr:
    """Rhai function pointer — `Fn("name")`, optionally curried.  Resolves
    by name at call time (script fn first, then host fn), like Rhai."""

    def __init__(self, name, curried=()):
        self.name = name
        self.curried = tuple(curried)


class RhaiRange:
    def __init__(self, lo, hi, inclusive):
        self.lo = lo
        self.hi = hi
        self.inclusive = inclusive

    def __iter__(self):
        hi = self.hi + 1 if self.inclusive else self.hi
        return iter(range(self.lo, hi))


class StepRange:
    """Rhai's `range(from, to, step)` (BasicIteratorPackage): iterates
    from `lo` toward `hi` (exclusive) by `step`, which may be negative;
    INT and FLOAT variants share this one class."""

    def __init__(self, lo, hi, step):
        if step == 0:
            raise RhaiRuntimeError("range(): step cannot be zero")
        self.lo = lo
        self.hi = hi
        self.step = step

    def __iter__(self):
        v = self.lo
        if self.step > 0:
            while v < self.hi:
                yield v
                v += self.step
        else:
            while v > self.hi:
                yield v
                v += self.step


class Timestamp:
    """Rhai's `timestamp()` (BasicTimePackage): an opaque monotonic
    instant; `elapsed` and timestamp differences are f64 seconds."""

    def __init__(self, t=None):
        import time

        self.t = time.monotonic() if t is None else t

    def __eq__(self, other):
        return isinstance(other, Timestamp) and self.t == other.t

    def __lt__(self, other):
        return self.t < other.t

    def __le__(self, other):
        return self.t <= other.t

    def __gt__(self, other):
        return self.t > other.t

    def __ge__(self, other):
        return self.t >= other.t

    def __hash__(self):
        return hash(self.t)


def to_display(v) -> str:
    """Rhai value -> string (for print/template interpolation)."""
    if v is UNIT or v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            return "NaN"  # Rust f64 Display
        if v == float("inf"):
            return "inf"
        if v == float("-inf"):
            return "-inf"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_debug_display(x) for x in v) + "]"
    if isinstance(v, dict):
        # Rhai's Map is a BTreeMap: iteration (and therefore display) is
        # key-sorted, regardless of insertion order
        return "#{" + ", ".join(
            f'"{k}": {_debug_display(v[k])}' for k in sorted(v)) + "}"
    if isinstance(v, FnPtr):
        return f"Fn({v.name})"
    return str(v)


def _debug_display(v) -> str:
    """Container elements print debug-style: strings get quotes (Rhai)."""
    if isinstance(v, str):
        return f'"{v}"'
    return to_display(v)


def _to_json(v) -> str:
    """Map.to_json(): compact JSON, key-sorted (BTreeMap iteration), unit
    as null, floats in Rhai display form (1.0 keeps its .0)."""
    import json

    if v is UNIT or v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return to_display(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ",".join(_to_json(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{json.dumps(k)}:{_to_json(v[k])}" for k in sorted(v)) + "}"
    return json.dumps(to_display(v))


# Rhai string methods that mutate the receiver in place and return ().
_STRING_INPLACE = frozenset({"trim", "make_upper", "make_lower", "replace",
                             "truncate", "crop", "pad", "clear", "remove"})

# In-place string methods that ALSO return a value (string_more's pop).
_STRING_INPLACE_RET = frozenset({"pop"})


def _str_span(s: str, args):
    """(start[, len]) or (range) -> python slice bounds on a string, with
    Rhai's negative-start-counts-from-the-end and clamping rules."""
    if args and isinstance(args[0], RhaiRange):
        lo = max(int(args[0].lo), 0)
        hi = int(args[0].hi) + (1 if args[0].inclusive else 0)
        hi = min(max(hi, lo), len(s))
        lo = min(lo, len(s))
        return lo, hi
    start = int(args[0]) if args else 0
    if start < 0:
        start = max(len(s) + start, 0)
    start = min(start, len(s))
    n = max(int(args[1]), 0) if len(args) > 1 else len(s) - start
    return start, min(start + n, len(s))


def _string_inplace(s: str, name: str, args) -> str:
    need = {"replace": 2, "truncate": 1, "crop": 1,
            "pad": 2, "remove": 1}.get(name, 0)
    if len(args) < need:
        sig = ", ".join(["string"] + [_type_of(a) for a in args])
        raise RhaiRuntimeError(f"function not found: {name} ({sig})")
    if name == "trim":
        return s.strip()
    if name == "make_upper":
        return s.upper()
    if name == "make_lower":
        return s.lower()
    if name == "replace":
        return s.replace(args[0], args[1])
    if name == "truncate":
        return s[: max(int(args[0]), 0)]
    if name == "crop":
        lo, hi = _str_span(s, args)
        return s[lo:hi]
    if name == "pad":
        # string_more pad: append the char/string until len >= target
        # (a multi-char pad may overshoot, like the reference)
        target = int(args[0])
        fill = args[1]
        if not isinstance(fill, str) or not fill:
            raise RhaiRuntimeError("pad(): expected a char or string pad")
        while len(s) < target:
            s += fill
        return s
    if name == "clear":
        return ""
    if name == "remove":
        # remove ALL occurrences of a char/substring
        sub = args[0]
        if not isinstance(sub, str):
            raise RhaiRuntimeError("remove(): expected a char or string")
        return s.replace(sub, "") if sub else s
    raise RhaiRuntimeError(f"unknown in-place string method '{name}'")


def _string_inplace_ret(s: str, name: str, args):
    """Mutating string methods with a return value -> (new_string, ret)."""
    if name == "pop":
        if not args:
            if not s:
                return s, UNIT
            return s[:-1], s[-1]
        n = int(args[0])
        if n <= 0:
            return s, ""
        return s[:-n] if n < len(s) else "", s[-n:] if n < len(s) else s
    raise RhaiRuntimeError(f"unknown in-place string method '{name}'")


# Minimum argument counts for std methods that index args[]: a wrong-arity
# call must surface as a catchable function-not-found script error, never
# a raw Python IndexError (which would escape the engine uncategorized).
_STD_MIN_ARITY = {
    "push": 1, "contains": 1, "map": 1, "filter": 1, "reduce": 1,
    "for_each": 1, "retain": 1, "drain": 1, "splice": 2, "index_of": 1,
    "find": 1, "some": 1, "all": 1, "none": 1, "insert": 2, "remove": 1,
    "truncate": 1, "chop": 1, "extract": 1, "append": 1, "pad": 2,
    "get": 1, "set": 2, "mixin": 1, "starts_with": 1, "ends_with": 1,
    "sub_string": 1, "replace": 2, "parse_int": 0, "parse_float": 0,
    "reduce_rev": 1, "find_map": 1, "fill_with": 1, "crop": 1,
}

# Numeric names valid in property-getter style (`x.floor`, `n.is_odd`):
# Rhai's std registers these as both methods and getters.
_NUM_PROPS = frozenset({
    "floor", "ceiling", "round", "int", "fraction",
    "is_nan", "is_finite", "is_infinite", "is_zero", "is_odd", "is_even",
})


def _truthy(v):
    if isinstance(v, bool):
        return v
    raise RhaiRuntimeError(f"expected bool condition, got {type(v).__name__}")


def _type_of(v) -> str:
    """Rhai's builtin type_of() names."""
    if v is UNIT or v is None:
        return "()"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "i64"
    if isinstance(v, float):
        return "f64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "map"
    if isinstance(v, (Closure, FnPtr)):
        return "Fn"
    if isinstance(v, (RhaiRange, StepRange)):
        return "range"
    if isinstance(v, Timestamp):
        return "timestamp"
    return type(v).__name__


def _cmp_class(v):
    """Type class for Rhai comparison dispatch: values of different
    classes are never `==` (and `!=` is always true), and an ordered
    comparison between them is a function-not-found error.  INT and
    FLOAT share the numeric class (Rhai registers the mixed builtins);
    bool is NOT numeric — `true == 1` is false in Rhai."""
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, float, np.integer, np.floating)):
        return "num"
    if isinstance(v, np.ndarray):
        return "bool" if v.dtype.kind == "b" else "num"
    if isinstance(v, str):
        return "str"
    if isinstance(v, list):
        return "list"
    if isinstance(v, dict):
        return "map"
    if v is UNIT or v is None:
        return "unit"
    return _type_of(v)


def _rhai_eq(l, r):
    """Rhai `==`: unlike classes are never equal; arrays/maps compare
    element-wise under the same rule (so [true] != [1]).  May return an
    ndarray in vectorized closure contexts."""
    cl = _cmp_class(l)
    if cl != _cmp_class(r):
        return False
    if cl == "list":
        if len(l) != len(r):
            return False
        for a, b in zip(l, r):
            e = _rhai_eq(a, b)
            if isinstance(e, np.ndarray):
                raise _PredicationUnsupported()
            if not e:
                return False
        return True
    if cl == "map":
        if l.keys() != r.keys():
            return False
        for k in l:
            e = _rhai_eq(l[k], r[k])
            if isinstance(e, np.ndarray):
                raise _PredicationUnsupported()
            if not e:
                return False
        return True
    return l == r


def _closure_fast(closure, interp):
    """Lazy import of the transpiler's closure compiler (pycompile imports
    this module, so the import can't be top-level)."""
    global _get_closure_fn
    if _get_closure_fn is None:
        from paintfe_tpu_torch.scripting.pycompile import get_closure_fn

        _get_closure_fn = get_closure_fn
    return _get_closure_fn(closure, interp)


_get_closure_fn = None


_I64_MASK = (1 << 64) - 1


def _wrap_i64(v: int) -> int:
    v &= _I64_MASK
    return v - (1 << 64) if v >= (1 << 63) else v


def _int_like(v) -> bool:
    """True for Rhai INT values in both scalar and vectorized (ndarray)
    closure contexts: python int / numpy integer scalar / integer-kind
    array (bool excluded — Rhai keeps bool and INT distinct)."""
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, np.integer)):
        return True
    return isinstance(v, np.ndarray) and v.dtype.kind in "iu"


def _f64fn(ufunc):
    """Wrap a numpy ufunc as a Rhai f64 math function: scalars come back
    as python floats, domain errors yield NaN (Rust f64 semantics — these
    functions never raise), arrays pass through for the bulk vectorizer."""

    def f(x):
        if isinstance(x, np.ndarray):
            with np.errstate(all="ignore"):
                return ufunc(x)
        with np.errstate(all="ignore"):
            return float(ufunc(float(x)))

    return f


def _std_log(x, base=None):
    if base is None:
        return _f64fn(np.log10)(x)
    b = float(base)
    with np.errstate(all="ignore"):
        v = float(np.log(float(x)))
        d = float(np.log(b))
    return v / d if d != 0 else float("nan")


def _std_atan(y, x=None):
    if x is None:
        return _f64fn(np.arctan)(y)
    return float(np.arctan2(float(y), float(x)))


# Rhai 1.25 standard-package functions the reference's engine exposes on
# top of its own registered API (scripting.rs:284-317 builds a default
# Engine, so BasicMathPackage etc. are all present).  Merged UNDER the
# host API at Interpreter init: a host registration always wins.
_STD_HOST_FNS = {
    "exp": _f64fn(np.exp),
    "ln": _f64fn(np.log),
    "log": _std_log,
    "hypot": lambda x, y: float(np.hypot(float(x), float(y))),
    "atan": _std_atan,
    "sinh": _f64fn(np.sinh),
    "cosh": _f64fn(np.cosh),
    "tanh": _f64fn(np.tanh),
    "asin": _f64fn(np.arcsin),
    "acos": _f64fn(np.arccos),
    "asinh": _f64fn(np.arcsinh),
    "acosh": _f64fn(np.arccosh),
    "atanh": _f64fn(np.arctanh),
    "E": lambda: float(np.e),
}


_NOMATCH = object()

# Scope-dict key prefix marking a binding as `const` (NUL can never start
# a script identifier, so markers are invisible to variable lookup).
_CONST_MARK = "\x00const:"


def _string_index_set(s, idx, op, value, binop):
    """`s[i] = ch` on a string: returns the rebuilt string (strings are
    immutable host-side; callers write it back to the receiver)."""
    n = len(s)
    i = int(idx)
    j = i + n if i < 0 else i
    if j < 0 or j >= n:
        raise RhaiRuntimeError(f"index error: string index {idx} out of range")
    if op != "=":
        value = binop(op[:-1], s[j], value)
    if not isinstance(value, str) or len(value) != 1:
        raise RhaiRuntimeError(
            f"string index assignment needs a char, got {_type_of(value)}")
    return s[:j] + value + s[j + 1:]


def _std_free_call(interp, name, args):
    """Rhai std free functions that need interpreter state or construct
    engine types; shared by the tree-walker and the compiled tier's _cn.
    Returns _NOMATCH when `name` isn't one of them."""
    if name == "range":
        vals = list(args)
        if len(vals) == 2:
            ok = all(isinstance(v, int) and not isinstance(v, bool)
                     for v in vals)
            if ok:
                return RhaiRange(vals[0], vals[1], False)
        elif len(vals) == 3:
            ok = all((isinstance(v, int) and not isinstance(v, bool))
                     or isinstance(v, float) for v in vals)
            if ok:
                return StepRange(vals[0], vals[1], vals[2])
        sig = ", ".join(_type_of(a) for a in args)
        raise RhaiRuntimeError(f"function not found: range ({sig})")
    if name == "timestamp" and not args:
        return Timestamp()
    if name == "is_def_fn":
        if (len(args) == 2 and isinstance(args[0], str)
                and isinstance(args[1], int) and not isinstance(args[1], bool)):
            ov = interp.user_fn_overloads.get(args[0])
            if ov:
                return args[1] in ov
            uf = interp.user_fns.get(args[0])
            if uf is not None:
                return len(uf[0]) == args[1]
            cf = interp.compiled_fns.get(args[0])
            if cf is not None:
                return cf.__code__.co_argcount == args[1]
            return False
    if name == "to_debug" and len(args) == 1:
        return _debug_display(args[0])
    return _NOMATCH


class _PredicationUnsupported(Exception):
    """A data-dependent construct that cannot be if-converted was hit while
    evaluating a closure on whole arrays; the bulk vectorizer catches this
    (like any vectorization failure) and falls back to the scalar loop."""


def _check_vector_shift(r):
    """Shift counts outside 0..63 raise in the scalar oracle (per pixel, with
    partial writes already applied); the vectorized pass cannot reproduce
    that, so bail to the exact loop instead of numpy's undefined shift."""
    if isinstance(r, np.ndarray):
        if ((r < 0) | (r > 63)).any():
            raise _PredicationUnsupported()
    elif isinstance(r, (int, np.integer)) and (r < 0 or r > 63):
        raise _PredicationUnsupported()


_I64_SAFE = float(2 ** 62)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _check_i64(v, l, op, r):
    """Rhai's default build uses CHECKED i64 arithmetic: out-of-range
    results are script errors, never Python bigints (the reference
    enables only the 'sync' feature, so 'unchecked' is off)."""
    if v < _I64_MIN or v > _I64_MAX:
        raise RhaiRuntimeError(f"integer overflow: {l} {op} {r}")
    return v


def _check_vector_overflow(op, l, r):
    """Vectorized i64 + - * ** wrap two's-complement (numpy int64) where the
    scalar tree-walker's Python ints don't; when any element's magnitude can
    approach i64 range, bail to the exact scalar loop.  The float64
    approximation is conservative (threshold 2^62, true wrap at 2^63):
    a false positive only costs vectorization, never correctness."""
    if not (_int_like(l) and _int_like(r)):
        return
    with np.errstate(over="ignore", invalid="ignore"):
        la = np.asarray(l, np.float64)
        ra = np.asarray(r, np.float64)
        if op == "+":
            approx = la + ra
        elif op == "-":
            approx = la - ra
        elif op == "*":
            approx = la * ra
        else:  # **
            # numpy also REJECTS negative integer exponents (ValueError)
            # where the scalar path raises a script error — fall back
            if (np.asarray(r) < 0).any():
                raise _PredicationUnsupported()
            approx = np.power(la, ra)
    if not (np.abs(approx) < _I64_SAFE).all():
        raise _PredicationUnsupported()


def _merge_predicated(cond, t, f):
    """np.where-merge of the two branch outcomes of an if-converted
    conditional under a per-pixel bool-array condition."""
    if t is f:
        return t
    if t is UNIT or f is UNIT:
        if t is UNIT and f is UNIT:
            return UNIT
        raise _PredicationUnsupported()
    if isinstance(t, list) and isinstance(f, list):
        if len(t) != len(f):
            raise _PredicationUnsupported()
        return [_merge_predicated(cond, a, b) for a, b in zip(t, f)]
    numlike = (int, float, np.integer, np.floating, np.bool_, np.ndarray)
    if isinstance(t, numlike) and isinstance(f, numlike):
        if (not isinstance(t, np.ndarray) and not isinstance(f, np.ndarray)
                and type(t) is type(f) and t == f):
            return t
        def kind(v):
            if isinstance(v, (bool, np.bool_)):
                return "b"
            if isinstance(v, np.ndarray):
                return "b" if v.dtype.kind == "b" else (
                    "i" if v.dtype.kind in "iu" else "f")
            return "i" if isinstance(v, (int, np.integer)) else "f"

        if kind(t) != kind(f):
            # np.where promotes across kinds (bool lanes become 0/1, int
            # lanes become floats) — per pixel the scalar loop keeps a
            # DYNAMIC type whose later semantics differ (bool keeps the
            # old channel; int arithmetic is CHECKED where float isn't);
            # unmergeable, bail to the exact loop
            raise _PredicationUnsupported()
        return np.where(cond, t, f)
    if isinstance(t, str) and isinstance(f, str) and t == f:
        return t
    raise _PredicationUnsupported()


class Interpreter:
    """One script run.  `host_fns` maps name -> (python callable taking
    evaluated args; may also accept Closure values)."""

    def __init__(self, host_fns: Dict[str, Any], max_operations: int = MAX_OPERATIONS):
        # std package fns sit UNDER the host API (a host registration of
        # the same name wins, like Rhai's later-registration precedence)
        merged = dict(_STD_HOST_FNS)
        merged.update(host_fns)
        self.host_fns = merged
        self.ops = 0
        self.max_operations = max_operations
        self.globals: Dict[str, Any] = {}
        self.user_fns: Dict[str, Any] = {}
        # Rhai script fns overload by ARITY: name -> {nargs: (params, body)}
        self.user_fn_overloads: Dict[str, Dict[int, Any]] = {}
        # populated by pycompile's runtime with the transpiled script fns
        # (name -> python callable), so FnPtr resolution inside std array
        # callbacks (map(Fn("f"))) works in the compiled tier too
        self.compiled_fns: Dict[str, Any] = {}
        self.depth = 0
        # name -> Closure shim wrapping a user fn's (params, body) over
        # [globals], so pycompile's closure compiler serves user fns too
        self._fn_shims: Dict[str, Closure] = {}

    # -- operation budget ----------------------------------------------------

    def tick(self):
        self.ops += 1
        if self.ops > self.max_operations:
            raise RhaiSystemError(
                f"script exceeded the operation limit ({self.max_operations})"
            )

    # -- execution -----------------------------------------------------------

    def run(self, source: str):
        ast = parse(source)
        # hoist fn declarations
        for stmt in ast[1]:
            if stmt[0] == "fn":
                self.user_fns[stmt[1]] = (stmt[2], stmt[3])
                self.user_fn_overloads.setdefault(
                    stmt[1], {})[len(stmt[2])] = (stmt[2], stmt[3])
        try:
            self.exec_block(ast, [self.globals])
        except _Throw as t:
            # uncaught `throw` terminates the script (Rhai ErrorRuntime)
            raise RhaiRuntimeError(f"Runtime error: {to_display(t.value)}")
        except _Return:
            # `return` at global level legally terminates the script
            pass
        return None

    def exec_block(self, block, scopes: List[dict]):
        value = UNIT
        for stmt in block[1]:
            value = self.exec_stmt(stmt, scopes)
        return value

    def exec_stmt(self, stmt, scopes):
        self.tick()
        kind = stmt[0]
        if kind in ("let", "const"):
            scopes[-1][stmt[1]] = _rhai_copy(self.eval(stmt[2], scopes))
            # const-ness attaches to the BINDING (a later `let` of the same
            # name shadows it away); the marker key can never collide with
            # a script identifier
            ck = _CONST_MARK + stmt[1]
            if kind == "const":
                scopes[-1][ck] = True
            else:
                scopes[-1].pop(ck, None)
            return UNIT
        if kind == "fn":
            self.user_fns[stmt[1]] = (stmt[2], stmt[3])
            self.user_fn_overloads.setdefault(
                stmt[1], {})[len(stmt[2])] = (stmt[2], stmt[3])
            return UNIT
        if kind == "assign":
            self._assign(stmt[1], stmt[2],
                         _rhai_copy(self.eval(stmt[3], scopes)), scopes)
            return UNIT
        if kind == "expr":
            v = self.eval(stmt[1], scopes)
            return UNIT if stmt[2] else v  # semicolon discards the value
        if kind == "while":
            while _truthy(self.eval(stmt[1], scopes)):
                self.tick()
                try:
                    self.exec_block(stmt[2], scopes + [{}])
                except _Break as b:
                    return UNIT if b.value is None else b.value
                except _Continue:
                    continue
            return UNIT
        if kind == "loop":
            while True:
                self.tick()
                try:
                    self.exec_block(stmt[1], scopes + [{}])
                except _Break as b:
                    return UNIT if b.value is None else b.value
                except _Continue:
                    continue
        if kind == "dowhile":
            _, cond, body, is_until = stmt
            while True:
                self.tick()
                try:
                    self.exec_block(body, scopes + [{}])
                except _Break as b:
                    return UNIT if b.value is None else b.value
                except _Continue:
                    pass
                done = _truthy(self.eval(cond, scopes))
                if is_until:
                    if done:
                        break
                elif not done:
                    break
            return UNIT
        if kind == "for":
            iterable = self.eval(stmt[2], scopes)
            if isinstance(iterable, (RhaiRange, StepRange)):
                it = iterable
            elif isinstance(iterable, list):
                # Rhai's for-in yields cloned VALUES over a snapshot:
                # mutating the loop variable must not write through to the
                # array (and body pushes don't extend the iteration)
                it = [_rhai_copy(x) for x in iterable]
            elif isinstance(iterable, str):
                it = list(iterable)  # Rhai iterates strings by char
            else:
                raise RhaiRuntimeError("for loop needs a range or array")
            var = stmt[1]
            if isinstance(var, tuple):
                # `for (v, i) in it`: second binding = iteration counter
                vname, iname = var
                for idx, v in enumerate(it):
                    self.tick()
                    try:
                        self.exec_block(stmt[3],
                                        scopes + [{vname: v, iname: idx}])
                    except _Break as b:
                        return UNIT if b.value is None else b.value
                    except _Continue:
                        continue
                return UNIT
            for v in it:
                self.tick()
                try:
                    self.exec_block(stmt[3], scopes + [{var: v}])
                except _Break as b:
                    return UNIT if b.value is None else b.value
                except _Continue:
                    continue
            return UNIT
        if kind == "break":
            raise _Break(None if len(stmt) < 2 or stmt[1] is None
                         else self.eval(stmt[1], scopes))
        if kind == "continue":
            raise _Continue()
        if kind == "return":
            raise _Return(UNIT if stmt[1] is None else self.eval(stmt[1], scopes))
        if kind == "throw":
            raise _Throw(UNIT if stmt[1] is None else self.eval(stmt[1], scopes))
        if kind == "try":
            _, body, var, catcher = stmt
            try:
                self.exec_block(body, scopes + [{}])
            except _Throw as t:
                err_val = t.value
            except RhaiSystemError:
                raise  # budget/cancel/depth are not catchable (Rhai semantics)
            except RhaiRuntimeError as ex:
                err_val = ex.message  # runtime errors catch as their message
            else:
                return UNIT
            self.exec_block(catcher, scopes + [{var: err_val} if var else {}])
            return UNIT
        raise RhaiRuntimeError(f"unknown statement {kind}")

    def _assign(self, target, op, value, scopes):
        if target[0] == "var":
            name = target[1]
            for scope in reversed(scopes):
                if name in scope:
                    if (_CONST_MARK + name) in scope:
                        # Rhai's ErrorAssignmentToConstant
                        raise RhaiRuntimeError(
                            f"cannot assign to constant '{name}'")
                    if op != "=":
                        value = self._binop(op[:-1], scope[name], value)
                    scope[name] = value
                    return
            raise RhaiRuntimeError(f"variable '{name}' not found")
        if target[0] == "index":
            obj = self.eval(target[1], scopes)
            idx = self.eval(target[2], scopes)
            if isinstance(obj, dict):
                if op != "=":
                    value = self._binop(op[:-1], obj.get(idx, UNIT), value)
                obj[idx] = value
                return
            if isinstance(obj, str):
                # Rhai strings support char set-by-index; Python strings
                # are immutable, so rebuild and write back to the base
                # (temporaries are not assignable, same error as below)
                if (target[1][0] in ("var", "index")
                        or (target[1][0] == "method"
                            and target[1][3] is None)):
                    ns = _string_index_set(obj, idx, op, value, self._binop)
                    return self._assign(target[1], "=", ns, scopes)
                raise RhaiRuntimeError(
                    "indexed assignment needs an array or map")
            if not isinstance(obj, list):
                raise RhaiRuntimeError("indexed assignment needs an array or map")
            if op != "=":
                value = self._binop(op[:-1], obj[idx], value)
            obj[idx] = value
            return
        if target[0] == "method" and target[3] is None:  # m.key = v
            obj = self.eval(target[1], scopes)
            if isinstance(obj, dict):
                if op != "=":
                    value = self._binop(op[:-1], obj.get(target[2], UNIT), value)
                obj[target[2]] = value
                return
            raise RhaiRuntimeError("property assignment needs a map")
        raise RhaiRuntimeError("invalid assignment target")

    # -- expressions ---------------------------------------------------------

    def eval(self, e, scopes):
        self.tick()
        kind = e[0]
        if kind == "int" or kind == "float" or kind == "str" or kind == "bool":
            return e[1]
        if kind == "unit":
            return UNIT
        if kind == "tstr":
            out = []
            for pk, payload in e[1]:
                out.append(payload if pk == "lit" else to_display(self.eval(payload, scopes)))
            return "".join(out)
        if kind == "var":
            name = e[1]
            for scope in reversed(scopes):
                if name in scope:
                    return scope[name]
            raise RhaiRuntimeError(f"variable '{name}' not found")
        if kind == "array":
            return [self.eval(x, scopes) for x in e[1]]
        if kind == "map":
            return {k: self.eval(v, scopes) for k, v in e[1]}
        if kind == "switch":
            _, subj_e, arms, default = e
            subject = self.eval(subj_e, scopes)
            for pats, guard, body in arms:
                if pats is None:  # guarded `_` arm: always pattern-matches
                    hit = True
                else:
                    hit = False
                    for pat in pats:
                        m = self.eval(pat, scopes)
                        if isinstance(m, RhaiRange):
                            hi = m.hi + 1 if m.inclusive else m.hi
                            hit = (
                                isinstance(subject, int)
                                and not isinstance(subject, bool)
                                and m.lo <= subject < hi
                            )
                        else:
                            # Rhai case match = same-type equality (1 never
                            # matches true); array subjects (vectorized
                            # closures) bail to the scalar loop
                            hit = _rhai_eq(m, subject)
                            if isinstance(hit, np.ndarray):
                                raise _PredicationUnsupported()
                        if hit:
                            break
                if hit and guard is not None:
                    # case condition: evaluated only when the pattern
                    # matched; false falls through to the NEXT arm
                    g = self.eval(guard, scopes)
                    if isinstance(g, np.ndarray):
                        raise _PredicationUnsupported()
                    hit = _truthy(g)
                if hit:
                    if body[0] == "block":
                        return self.exec_block(body, scopes + [{}])
                    return self.eval(body, scopes)
            if default is not None:
                if default[0] == "block":
                    return self.exec_block(default, scopes + [{}])
                return self.eval(default, scopes)
            return UNIT
        if kind == "index":
            obj = self.eval(e[1], scopes)
            idx = self.eval(e[2], scopes)
            try:
                return obj[idx]
            except (IndexError, TypeError, KeyError) as exc:
                raise RhaiRuntimeError(f"index error: {exc}")
        if kind == "bin":
            return self._binop(e[1], self.eval(e[2], scopes), self.eval(e[3], scopes))
        if kind == "un":
            v = self.eval(e[2], scopes)
            if e[1] == "-":
                if _cmp_class(v) != "num":
                    # Rhai negation exists only for INT/FLOAT (-true errors)
                    raise RhaiRuntimeError(
                        f"function not found: - ({_type_of(v)})")
                if isinstance(v, int) and v == _I64_MIN:
                    raise RhaiRuntimeError(f"integer overflow: -{v}")
                return -v
            if e[1] == "!":
                if isinstance(v, np.ndarray):
                    if v.dtype != np.bool_:
                        # scalar oracle errors on '!' of a non-bool; fall
                        # back to the exact loop rather than emit ~int
                        raise _PredicationUnsupported()
                    return ~v  # vectorized closure context
                return not _truthy(v)
        if kind == "and":
            l = self.eval(e[1], scopes)
            if isinstance(l, np.ndarray):
                # array condition (bulk vectorizer): non-short-circuit is
                # safe — the purity scan proved the operands effect-free
                return l & self.eval(e[2], scopes)
            if not _truthy(l):
                return False
            r = self.eval(e[2], scopes)
            return r if isinstance(r, np.ndarray) else _truthy(r)
        if kind == "or":
            l = self.eval(e[1], scopes)
            if isinstance(l, np.ndarray):
                return l | self.eval(e[2], scopes)
            if _truthy(l):
                return True
            r = self.eval(e[2], scopes)
            return r if isinstance(r, np.ndarray) else _truthy(r)
        if kind == "range":
            lo = self.eval(e[1], scopes)
            hi = self.eval(e[2], scopes)
            return RhaiRange(int(lo), int(hi), e[3])
        if kind == "if":
            c = self.eval(e[1], scopes)
            if isinstance(c, np.ndarray):
                return self._predicated_if(c, e[2], e[3], scopes)
            if _truthy(c):
                return self.exec_block(e[2], scopes + [{}])
            if e[3] is not None:
                return self.exec_block(e[3], scopes + [{}])
            return UNIT
        if kind == "block":
            return self.exec_block(e, scopes + [{}])
        if kind == "stmtexpr":
            # loop expression: value = break value (or () on normal exit)
            return self.exec_stmt(e[1], scopes)
        if kind == "closure":
            return Closure(e[1], e[2], scopes)
        if kind == "call":
            args = [self.eval(a, scopes) for a in e[2]]
            return self.call_function(e[1], args, scopes)
        if kind == "method":
            obj = self.eval(e[1], scopes)
            args = None if e[3] is None else [self.eval(a, scopes) for a in e[3]]
            if (
                args is not None
                and isinstance(obj, str)
                and e[2] in _STRING_INPLACE
                and (e[1][0] in ("var", "index")
                     or (e[1][0] == "method" and e[1][3] is None))
            ):
                # Rhai string methods like trim/replace mutate the receiver
                # and return (); Python strings are immutable so write back.
                self._assign(e[1], "=", _string_inplace(obj, e[2], args), scopes)
                return UNIT
            if (
                args is not None
                and isinstance(obj, str)
                and e[2] in _STRING_INPLACE_RET
                and (e[1][0] in ("var", "index")
                     or (e[1][0] == "method" and e[1][3] is None))
            ):
                # pop() both mutates the receiver and returns the removed
                # character(s)
                ns, ret = _string_inplace_ret(obj, e[2], args)
                self._assign(e[1], "=", ns, scopes)
                return ret
            return self._method(obj, e[2], args, scopes)
        raise RhaiRuntimeError(f"unknown expression {kind}")

    def _predicated_if(self, cond, then_blk, else_blk, scopes):
        """If-conversion for the bulk vectorizer (scripting.rs:437-495's
        per-pixel closures): when an `if` condition evaluates to a bool
        ARRAY (one truth value per pixel), run BOTH branches on copies of
        the scope chain and np.where-merge every variable write plus the
        result value.  Legal only because the purity scan already proved
        the closure body free of observable effects; constructs that cannot
        be merged (control-flow escapes, type-divergent writes) raise
        _PredicationUnsupported, which the vectorizer catches to fall back
        to the exact scalar loop."""
        if cond.dtype != np.bool_:
            raise _PredicationUnsupported()
        sc_t = [{k: _rhai_copy(v) for k, v in s.items()} for s in scopes]
        sc_f = [{k: _rhai_copy(v) for k, v in s.items()} for s in scopes]
        try:
            v_t = self.exec_block(then_blk, sc_t + [{}])
            v_f = (self.exec_block(else_blk, sc_f + [{}])
                   if else_blk is not None else UNIT)
        except (_Break, _Continue, _Return, _Throw):
            raise _PredicationUnsupported()
        for orig, st, sf in zip(scopes, sc_t, sc_f):
            for name in orig:
                orig[name] = _merge_predicated(cond, st[name], sf[name])
        return _merge_predicated(cond, v_t, v_f)

    def call_function(self, name, args, scopes, deref_vars=True):
        # A variable holding a closure (FnPtr) is directly callable in Rhai.
        # Dereferencing an FnPtr resolves FUNCTIONS only (user/host fns) —
        # never variables again: `let f = Fn("f"); f();` must be "function
        # not found", not unbounded recursion through the same scope (and
        # the compiled engine already implements exactly this rule).
        if deref_vars:
            for scope in reversed(scopes):
                if name in scope:
                    v = scope[name]
                    if isinstance(v, Closure):
                        return self.call_closure(v, args)
                    if isinstance(v, FnPtr):
                        return self.call_function(
                            v.name, list(v.curried) + list(args), scopes,
                            deref_vars=False)
                    break
        if name == "Fn":  # function-pointer constructor: Fn("name")
            if len(args) != 1 or not isinstance(args[0], str):
                raise RhaiRuntimeError("Fn() expects one string argument")
            return FnPtr(args[0])
        if name == "type_of" and len(args) == 1 and "type_of" not in self.host_fns:
            return _type_of(args[0])
        if name == "eval" and not deref_vars:
            # via a function pointer there is no lexical scope to inject
            # into (and the compiled tier compiles scopes away entirely)
            raise RhaiRuntimeError(
                "eval is not available through function pointers")
        if name == "eval":
            # Rhai's infamous eval is ENABLED in the reference (Engine::new
            # at scripting.rs:284 never disable_symbol's it): the snippet
            # runs in the CURRENT scope — new `let`s persist into the
            # innermost block scope — and the last statement's value is
            # returned.  Function definitions are rejected (Rhai forbids fn
            # defs inside eval); parse errors are catchable runtime errors.
            if len(args) != 1 or not isinstance(args[0], str):
                raise RhaiRuntimeError("eval expects one string argument")
            from paintfe_tpu_torch.scripting.rhai_ast import (RhaiSyntaxError,
                                                        parse as _parse)

            self.depth += 1
            if self.depth > MAX_CALL_DEPTH:
                self.depth -= 1
                raise RhaiSystemError("maximum call depth exceeded")
            try:
                try:
                    ast = _parse(args[0])
                except RhaiSyntaxError as ex:
                    raise RhaiRuntimeError(f"eval: syntax error: {ex}")
                for st in ast[1]:
                    if st[0] == "fn":
                        raise RhaiRuntimeError(
                            "cannot define functions inside eval")
                return self.exec_block(ast, scopes)
            finally:
                self.depth -= 1
        if name in self.user_fns:
            params, body = self.user_fns[name]
            ov = self.user_fn_overloads.get(name)
            if ov is not None and len(args) in ov:
                # Rhai script fns overload by arity; exact match wins
                params, body = ov[len(args)]
            if len(params) != len(args):
                if ov is not None and len(ov) > 1:
                    sig = ", ".join(_type_of(a) for a in args)
                    raise RhaiRuntimeError(
                        f"function not found: {name} ({sig})")
                raise RhaiRuntimeError(f"function '{name}' expects {len(params)} args")
            self.depth += 1
            if self.depth > MAX_CALL_DEPTH:
                self.depth -= 1
                raise RhaiSystemError("maximum call depth exceeded")
            try:
                # compiled-body fast path (user fns are closures over the
                # globals scope); array args keep the tree-walker for the
                # bulk vectorizer's benefit
                if not any(isinstance(a, np.ndarray) for a in args):
                    shim_key = (name, len(params))
                    shim = self._fn_shims.get(shim_key)
                    if (shim is None or shim.body is not body
                            or shim.params is not params):
                        shim = Closure(params, body, [self.globals])
                        self._fn_shims[shim_key] = shim
                    fast = _closure_fast(shim, self)
                    if fast is not None:
                        return fast(self, args)
                local = dict(zip(params, [_rhai_copy(a) for a in args]))
                try:
                    return self.exec_block(body, [self.globals, local])
                except _Return as r:
                    return r.value
            finally:
                self.depth -= 1
        cf = self.compiled_fns.get(name)
        if cf is not None:
            if cf.__code__.co_argcount != len(args):
                raise RhaiRuntimeError(
                    f"function '{name}' expects {cf.__code__.co_argcount} args")
            return cf(*args)
        fn = self.host_fns.get(name)
        if fn is None:
            r = _std_free_call(self, name, args)
            if r is not _NOMATCH:
                return r
            if name == "is_def_var":
                if len(args) == 1 and isinstance(args[0], str):
                    return any(args[0] in s for s in scopes)
            # Rhai's unified call notation: `f(x, y)` falls back to the
            # method `x.f(y)` (so parse_int("7"), to_upper(s), push(a, v)
            # all resolve).  ndarray first-args keep the strict path for
            # the vectorizer's bail semantics.
            if args and not isinstance(args[0], np.ndarray):
                try:
                    return self._method(args[0], name, list(args[1:]), scopes)
                except RhaiRuntimeError as me:
                    if not str(me).startswith(
                            ("unknown method", "unknown property")):
                        raise
            # Rhai-style signature with ARG TYPES ("fx (i64, i64)"), which
            # the friendly categorizer shows verbatim (scripting.rs:115-124)
            sig = ", ".join(_type_of(a) for a in args)
            raise RhaiRuntimeError(f"function not found: {name} ({sig})")
        try:
            return fn(*args)
        except TypeError as e:
            # wrong-arity HOST calls must be catchable script errors, not
            # raw TypeErrors escaping the engine (Rhai reports function-
            # not-found).  Signature-bind only on the error path, so a
            # TypeError raised INSIDE the host fn still propagates.
            import inspect

            try:
                inspect.signature(fn).bind(*args)
            except TypeError:
                sig = ", ".join(_type_of(a) for a in args)
                raise RhaiRuntimeError(f"function not found: {name} ({sig})")
            raise e

    def call_closure(self, closure: Closure, args):
        if len(closure.params) != len(args):
            raise RhaiRuntimeError(
                f"closure expects {len(closure.params)} args, got {len(args)}"
            )
        # Fast path: the closure body compiled to Python bytecode
        # (pycompile.get_closure_fn), used only for scalar args — array
        # args mean the bulk vectorizer is driving, whose predicated
        # if-conversion needs THIS tree-walker's eval hooks.
        if not any(isinstance(a, np.ndarray) for a in args):
            fast = _closure_fast(closure, self)
            if fast is not None:
                return fast(self, args)
        local = dict(zip(closure.params, [_rhai_copy(a) for a in args]))
        try:
            return self.exec_block(closure.body, list(closure.scope_chain) + [local])
        except _Return as r:
            return r.value

    # -- operators -----------------------------------------------------------

    def _binop(self, op, l, r):
        import numpy as np

        is_arr = isinstance(l, np.ndarray) or isinstance(r, np.ndarray)
        both_int = (isinstance(l, int) and not isinstance(l, bool)) and (
            isinstance(r, int) and not isinstance(r, bool)
        )
        if op in ("+", "-", "*", "/", "%", "**"):
            if isinstance(l, Timestamp) or isinstance(r, Timestamp):
                # BasicTimePackage arithmetic: ts - ts -> f64 seconds;
                # ts +/- seconds -> timestamp.  Anything else is
                # ErrorFunctionNotFound like every other type mismatch.
                if (op == "-" and isinstance(l, Timestamp)
                        and isinstance(r, Timestamp)):
                    return float(l.t - r.t)
                if (op in ("+", "-") and isinstance(l, Timestamp)
                        and isinstance(r, (int, float))
                        and not isinstance(r, bool)):
                    d = float(r) if op == "+" else -float(r)
                    return Timestamp(l.t + d)
                raise RhaiRuntimeError(
                    f"function not found: {op} ({_type_of(l)}, {_type_of(r)})")
            if op == "+":
                if isinstance(l, str) or isinstance(r, str):
                    return (l + r
                            if isinstance(l, str) and isinstance(r, str)
                            else to_display(l) + to_display(r))
                if isinstance(l, list) and isinstance(r, list):
                    return l + r  # Rhai array concat (new array)
                if isinstance(l, dict) and isinstance(r, dict):
                    m = dict(l)
                    m.update(r)
                    return m  # Rhai map merge (rhs wins)
            # Rhai arithmetic builtins exist only for INT/FLOAT: bool,
            # unit, arrays, maps etc. are ErrorFunctionNotFound (`true + 1`
            # errors, never Python's 2); this also blocks Python sequence
            # repetition for '*' (a clone-on-let aliasing escape hatch)
            if _cmp_class(l) != "num" or _cmp_class(r) != "num":
                raise RhaiRuntimeError(
                    f"function not found: {op} ({_type_of(l)}, {_type_of(r)})")
        if op == "+":
            if is_arr:
                _check_vector_overflow(op, l, r)
                return l + r
            if both_int:
                return _check_i64(l + r, l, "+", r)
            return l + r
        if op == "-":
            if is_arr:
                _check_vector_overflow(op, l, r)
                return l - r
            if both_int:
                return _check_i64(l - r, l, "-", r)
            return l - r
        if op == "*":
            if is_arr:
                _check_vector_overflow(op, l, r)
                return l * r
            if both_int:
                return _check_i64(l * r, l, "*", r)
            return l * r
        if op == "/":
            if both_int:
                if r == 0:
                    raise RhaiRuntimeError("division by zero")
                q = abs(l) // abs(r)
                return _check_i64(q if (l >= 0) == (r >= 0) else -q,
                                  l, "/", r)
            if is_arr:
                if _int_like(l) and _int_like(r):
                    # Rust i64 semantics: truncate toward zero (numpy //
                    # floors), bit-identical to the scalar loop above
                    ra = np.asarray(r)
                    if (ra == 0).any():
                        raise RhaiRuntimeError("division by zero")
                    q = np.abs(l) // np.abs(ra)
                    return np.where((np.asarray(l) >= 0) == (ra >= 0), q, -q)
                return l / r  # vectorized float semantics
            # f64 division is IEEE like Rhai's (1.0/0.0 = inf, 0.0/0.0 =
            # NaN) — Python's ZeroDivisionError would be uncatchable by
            # script try/catch and escape the engine uncategorized
            with np.errstate(divide="ignore", invalid="ignore"):
                return float(np.float64(l) / np.float64(r))
        if op == "%":
            if both_int:
                if r == 0:
                    raise RhaiRuntimeError("modulo by zero")
                if l == _I64_MIN and r == -1:
                    # Rust checked_rem: the one i64 % that overflows
                    raise RhaiRuntimeError(f"integer overflow: {l} % {r}")
                rem = abs(l) % abs(r)  # Rust % truncates toward zero (exact)
                return rem if l >= 0 else -rem
            if is_arr:
                if _int_like(l) and _int_like(r) and (np.asarray(r) == 0).any():
                    raise RhaiRuntimeError("modulo by zero")
                return np.fmod(l, r)
            with np.errstate(divide="ignore", invalid="ignore"):
                return float(np.fmod(l, r))  # x % 0.0 = NaN (Rust f64 %)
        if op == "**":
            if is_arr:
                _check_vector_overflow(op, l, r)
                return l**r
            if both_int:
                if r < 0:
                    # Rhai's checked i64 pow rejects negative exponents;
                    # Python would silently produce a float
                    raise RhaiRuntimeError(
                        "integer raised to a negative exponent")
                # checked_pow: quick magnitude gate so 2 ** 10^18 errors
                # instead of materializing an astronomical bigint
                if abs(l) > 1 and r > 63:
                    raise RhaiRuntimeError(f"integer overflow: {l} ** {r}")
                return _check_i64(l**r, l, "**", r)
            # f64 powf: full IEEE — (-2.0)**0.5 = NaN (Python makes it
            # complex), 0.0**-1.0 = inf (Python raises)
            with np.errstate(divide="ignore", invalid="ignore"):
                return float(np.power(np.float64(l), np.float64(r)))
        if op == "&":
            if isinstance(l, bool) and isinstance(r, bool):
                return l and r  # non-short-circuit boolean AND (Rhai)
            if both_int or is_arr:
                return l & r
            raise RhaiRuntimeError("'&' needs two ints or two bools")
        if op == "|":
            if isinstance(l, bool) and isinstance(r, bool):
                return l or r
            if both_int or is_arr:
                return l | r
            raise RhaiRuntimeError("'|' needs two ints or two bools")
        if op == "^":
            if isinstance(l, bool) and isinstance(r, bool):
                return l != r
            if both_int or is_arr:
                return l ^ r
            raise RhaiRuntimeError("'^' needs two ints or two bools")
        if op == "<<":
            if is_arr:
                _check_vector_shift(r)
                # numpy int64 << wraps two's-complement like _wrap_i64
                return l << r
            if not both_int:
                raise RhaiRuntimeError("'<<' needs two ints")
            if r < 0 or r > 63:
                raise RhaiRuntimeError(f"integer overflow: << {r}")
            return _wrap_i64(l << r)
        if op == ">>":
            if is_arr:
                _check_vector_shift(r)
                return l >> r  # numpy int64 >> is arithmetic, like Rust i64
            if not both_int:
                raise RhaiRuntimeError("'>>' needs two ints")
            if r < 0 or r > 63:
                raise RhaiRuntimeError(f"integer overflow: >> {r}")
            return l >> r  # Python >> is arithmetic, like Rust i64
        if op == "in":
            if isinstance(r, dict):
                return l in r
            if isinstance(r, str):
                return l in r
            if isinstance(r, list):
                # array membership uses Rhai == per element (true !in [1])
                if isinstance(l, np.ndarray):
                    raise _PredicationUnsupported()
                for x in r:
                    e = _rhai_eq(l, x)
                    if isinstance(e, np.ndarray):
                        raise _PredicationUnsupported()
                    if e:
                        return True
                return False
            if isinstance(r, RhaiRange):
                hi = r.hi + 1 if r.inclusive else r.hi
                return r.lo <= l < hi
            raise RhaiRuntimeError("'in' needs an array, map, string or range")
        if op == "==":
            return _rhai_eq(l, r)
        if op == "!=":
            e = _rhai_eq(l, r)
            return ~e if isinstance(e, np.ndarray) else not e
        if op in ("<", "<=", ">", ">="):
            cl = _cmp_class(l)
            if cl != _cmp_class(r) or cl not in ("num", "str", "timestamp"):
                # Rhai defines ordering only for numerics and strings;
                # anything else is ErrorFunctionNotFound
                raise RhaiRuntimeError(
                    f"function not found: {op} ({_type_of(l)}, {_type_of(r)})")
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            return l >= r
        raise RhaiRuntimeError(f"unknown operator {op}")

    # -- std-library callbacks (map/filter/... take a closure or Fn ptr) -----

    def _cb(self, fn, cargs, scopes):
        """Invoke a map/filter/sort-style callback.  Closure and user-fn
        calls clone their arguments (Rhai by-value args) inside
        call_closure/call_function."""
        if isinstance(fn, Closure):
            return self.call_closure(fn, cargs)
        if isinstance(fn, FnPtr):
            return self.call_function(
                fn.name, list(fn.curried) + list(cargs),
                scopes if scopes is not None else [self.globals],
                deref_vars=False)
        raise RhaiRuntimeError(
            f"expected a function argument, got {_type_of(fn)}")

    def _cb_arity(self, fn):
        if isinstance(fn, Closure):
            return len(fn.params)
        if isinstance(fn, FnPtr):
            uf = self.user_fns.get(fn.name)
            if uf is not None:
                return len(uf[0]) - len(fn.curried)
            cf = self.compiled_fns.get(fn.name)
            if cf is not None:
                return cf.__code__.co_argcount - len(fn.curried)
        return None  # host fn behind an Fn pointer: arity unknown

    def _cb_pred(self, fn, v, i, scopes):
        """Predicate invocation with Rhai's arity adaptation ((item) or
        (item, index)); result must be a bool."""
        want = self._cb_arity(fn)
        r = self._cb(fn, [v, i] if want == 2 else [v], scopes)
        return _truthy(r)

    @staticmethod
    def _need(args, n, name, obj):
        """Arity guard for std methods: a wrong-arity call must surface as
        a catchable Rhai error (the reference reports function-not-found
        with the receiver type), never a raw Python IndexError."""
        if len(args) < n:
            sig = ", ".join([_type_of(obj)] + [_type_of(a) for a in args])
            raise RhaiRuntimeError(f"function not found: {name} ({sig})")

    def _arr_span(self, length, args):
        """Array span from (start[, len]) ints or a (range) argument —
        Rhai 1.25's std array methods accept both forms."""
        if args and isinstance(args[0], RhaiRange):
            lo = max(int(args[0].lo), 0)
            hi = int(args[0].hi) + (1 if args[0].inclusive else 0)
            hi = min(max(hi, lo), length)
            lo = min(lo, length)
            return lo, hi - lo
        return self._std_range(
            length, args[0], args[1] if len(args) > 1 else length)

    @staticmethod
    def _std_range(length, start, n):
        """Rhai array range normalization: negative start counts from the
        end (clamped to 0), start past the end is empty, negative/overlong
        counts clamp."""
        start = int(start)
        if start < 0:
            start = max(length + start, 0)
        if start > length:
            start = length
        n = max(int(n), 0)
        return start, min(n, length - start)

    def _method(self, obj, name, args, scopes=None):
        import math

        if args is not None:
            # Rhai passes call ARGUMENTS by value (only the receiver is a
            # reference): `arr.push(a)` stores a clone of `a`, so later
            # mutations of `a` must not alias into `arr`.  Scalars,
            # strings, and closures pass through _rhai_copy unchanged.
            args = [_rhai_copy(a) for a in args]
            need = _STD_MIN_ARITY.get(name)
            if need and len(args) < need:
                sig = ", ".join([_type_of(obj)] + [_type_of(a) for a in args])
                raise RhaiRuntimeError(f"function not found: {name} ({sig})")
        if isinstance(obj, Closure) and args is not None:
            if name == "call":
                return self.call_closure(obj, args)
            if name == "curry":
                if len(args) > len(obj.params):
                    raise RhaiRuntimeError(
                        f"curry: closure takes {len(obj.params)} args")
                pre = dict(zip(obj.params[: len(args)],
                               [_rhai_copy(a) for a in args]))
                return Closure(obj.params[len(args):], obj.body,
                               list(obj.scope_chain) + [pre])
        if isinstance(obj, FnPtr):
            if args is None:  # property access
                if name == "name":
                    return obj.name
                if name == "is_anonymous":
                    return False
                raise RhaiRuntimeError(f"unknown property '{name}' on Fn")
            if name == "call":
                return self.call_function(
                    obj.name, list(obj.curried) + list(args),
                    scopes if scopes is not None else [self.globals],
                    deref_vars=False)
            if name == "curry":
                return FnPtr(obj.name, list(obj.curried) + list(args))
        if args is None:  # property access
            if name == "len" and isinstance(obj, (list, str)):
                return len(obj)
            if isinstance(obj, dict):
                if name in obj:
                    return obj[name]
                if name == "len":
                    return len(obj)
                raise RhaiRuntimeError(f"map has no property '{name}'")
            if name == "bytes" and isinstance(obj, str):
                return len(obj.encode("utf-8"))
            if name == "is_empty" and isinstance(obj, (list, str)):
                return len(obj) == 0
            if name == "elapsed" and isinstance(obj, Timestamp):
                import time

                return time.monotonic() - obj.t
            if (isinstance(obj, (int, float)) and not isinstance(obj, bool)
                    and name in _NUM_PROPS):
                # Rhai registers the numeric classifiers/parts as getters
                # too: `x.floor`, `n.is_odd` are property-style calls
                return self._method(obj, name, [])
            raise RhaiRuntimeError(f"unknown property '{name}'")
        if isinstance(obj, list):
            if name == "len":
                return len(obj)
            if name == "is_empty":
                return len(obj) == 0
            if name == "push":
                obj.append(args[0])
                return UNIT
            if name == "pop":
                return obj.pop() if obj else UNIT
            if name == "clear":
                obj.clear()
                return UNIT
            if name == "contains":
                # Rhai == per element (same-type: [1].contains(true) is
                # false); delegate to the 'in' operator's rules
                return self._binop("in", args[0], obj)
            # -- Rhai 1.25 standard array package (scripting.rs:284-317
            # embeds the default std packages, so reference scripts use
            # these freely).  Mutating methods operate on the receiver in
            # place; callbacks may be closures or Fn pointers, with the
            # (item) / (item, index) arity adaptation Rhai applies.
            if name == "map":
                fn = args[0]
                want = self._cb_arity(fn)
                out = []
                for i, v in enumerate(list(obj)):
                    self.tick()
                    out.append(self._cb(fn, [v, i] if want == 2 else [v],
                                        scopes))
                return out
            if name == "filter":
                fn = args[0]
                out = []
                for i, v in enumerate(list(obj)):
                    self.tick()
                    if self._cb_pred(fn, v, i, scopes):
                        # clone-on-collect: the result must not alias the
                        # receiver's elements (Rhai Dynamic clone)
                        out.append(_rhai_copy(v))
                return out
            if name == "reduce":
                fn = args[0]
                acc = args[1] if len(args) > 1 else UNIT
                want = self._cb_arity(fn)
                for i, v in enumerate(list(obj)):
                    self.tick()
                    acc = self._cb(fn, [acc, v, i] if want == 3 else [acc, v],
                                   scopes)
                return acc
            if name == "for_each":
                fn = args[0]
                want = self._cb_arity(fn)
                for i, v in enumerate(list(obj)):
                    self.tick()
                    self._cb(fn, [v, i] if want == 2 else [v], scopes)
                return UNIT
            if name == "sort":
                if args:
                    fn = args[0]

                    def cmp(a, b):
                        self.tick()
                        r = self._cb(fn, [a, b], scopes)
                        if isinstance(r, bool) or not isinstance(r, int):
                            # Rhai's sort quietly falls back when the
                            # comparator yields a non-INT (it never
                            # aborts the sort); treat as equal — the
                            # stable sort then preserves input order.
                            # Comparator ERRORS still propagate (clearer
                            # than silently swallowing them).
                            return 0
                        return -1 if r < 0 else (1 if r > 0 else 0)

                    import functools

                    obj.sort(key=functools.cmp_to_key(cmp))
                    return UNIT
                if len(obj) > 1:
                    # no-comparator sort requires one homogeneous type
                    # (Rhai compares TypeIds: [1, 2.0].sort() errors)
                    kinds = {_type_of(x) for x in obj}
                    if len(kinds) > 1:
                        raise RhaiRuntimeError(
                            "sort(): array elements must all be the same type")
                    k = kinds.pop()
                    if k not in ("i64", "f64", "string", "bool"):
                        if k != "()":
                            raise RhaiRuntimeError(
                                f"sort(): cannot compare values of type {k}")
                    else:
                        obj.sort()
                return UNIT
            if name == "reverse":
                obj.reverse()
                return UNIT
            if name == "retain":
                if args and isinstance(args[0], (Closure, FnPtr)):
                    fn = args[0]
                    kept, removed = [], []
                    for i, v in enumerate(list(obj)):
                        self.tick()
                        (kept if self._cb_pred(fn, v, i, scopes)
                         else removed).append(v)
                    obj[:] = kept
                    return removed
                start, n = self._arr_span(len(obj), args)
                removed = obj[:start] + obj[start + n:]
                obj[:] = obj[start:start + n]
                return removed
            if name == "drain":
                if args and isinstance(args[0], (Closure, FnPtr)):
                    fn = args[0]
                    kept, removed = [], []
                    for i, v in enumerate(list(obj)):
                        self.tick()
                        (removed if self._cb_pred(fn, v, i, scopes)
                         else kept).append(v)
                    obj[:] = kept
                    return removed
                start, n = self._arr_span(len(obj), args)
                removed = obj[start:start + n]
                del obj[start:start + n]
                return removed
            if name == "splice":
                if isinstance(args[0], RhaiRange):
                    start, n = self._arr_span(len(obj), args)
                    repl = args[1]
                else:
                    self._need(args, 3, "splice", obj)
                    start, n = self._std_range(len(obj), args[0], args[1])
                    repl = args[2]
                if not isinstance(repl, list):
                    raise RhaiRuntimeError("splice() replacement must be an array")
                obj[start:start + n] = repl  # args were cloned on entry
                return UNIT
            if name == "index_of":
                start = int(args[1]) if len(args) > 1 else 0
                if start < 0:
                    start = max(len(obj) + start, 0)
                if isinstance(args[0], (Closure, FnPtr)):
                    fn = args[0]
                    for i in range(start, len(obj)):
                        self.tick()
                        if self._cb_pred(fn, obj[i], i, scopes):
                            return i
                    return -1
                for i in range(start, len(obj)):
                    self.tick()
                    e = _rhai_eq(args[0], obj[i])
                    if isinstance(e, np.ndarray):
                        raise _PredicationUnsupported()
                    if e:
                        return i
                return -1
            if name == "find":
                fn = args[0]
                start = int(args[1]) if len(args) > 1 else 0
                if start < 0:
                    start = max(len(obj) + start, 0)
                for i in range(start, len(obj)):
                    self.tick()
                    if self._cb_pred(fn, obj[i], i, scopes):
                        return _rhai_copy(obj[i])
                return UNIT
            if name == "some":
                fn = args[0]
                for i, v in enumerate(list(obj)):
                    self.tick()
                    if self._cb_pred(fn, v, i, scopes):
                        return True
                return False
            if name == "all":
                fn = args[0]
                for i, v in enumerate(list(obj)):
                    self.tick()
                    if not self._cb_pred(fn, v, i, scopes):
                        return False
                return True
            if name == "none":
                fn = args[0]
                for i, v in enumerate(list(obj)):
                    self.tick()
                    if self._cb_pred(fn, v, i, scopes):
                        return False
                return True
            if name == "insert":
                pos = int(args[0])
                if pos < 0:
                    pos = max(len(obj) + pos, 0)
                obj.insert(pos, args[1])  # append when pos >= len
                return UNIT
            if name == "remove":
                pos = int(args[0])
                if pos < 0:
                    pos += len(obj)
                if pos < 0 or pos >= len(obj):
                    return UNIT  # Rhai: invalid index removes nothing
                return obj.pop(pos)
            if name == "shift":
                return obj.pop(0) if obj else UNIT
            if name == "truncate":
                del obj[max(int(args[0]), 0):]
                return UNIT
            if name == "chop":
                keep = max(int(args[0]), 0)
                if keep < len(obj):
                    del obj[: len(obj) - keep]
                return UNIT
            if name == "extract":
                start, n = self._arr_span(len(obj), args)
                return [_rhai_copy(x) for x in obj[start:start + n]]
            if name == "reduce_rev":
                fn = args[0]
                acc = args[1] if len(args) > 1 else UNIT
                want = self._cb_arity(fn)
                for i in range(len(obj) - 1, -1, -1):
                    self.tick()
                    v = obj[i]
                    acc = self._cb(fn, [acc, v, i] if want == 3 else [acc, v],
                                   scopes)
                return acc
            if name == "find_map":
                fn = args[0]
                start = int(args[1]) if len(args) > 1 else 0
                if start < 0:
                    start = max(len(obj) + start, 0)
                want = self._cb_arity(fn)
                for i in range(start, len(obj)):
                    self.tick()
                    r = self._cb(fn, [obj[i], i] if want == 2 else [obj[i]],
                                 scopes)
                    if r is not UNIT:
                        return r
                return UNIT
            if name == "dedup":
                # remove CONSECUTIVE duplicates (Vec::dedup), comparing with
                # Rhai == (or the supplied two-arg predicate)
                fn = args[0] if args else None
                out = []
                for v in obj:
                    self.tick()
                    if out:
                        if fn is not None:
                            same = _truthy(self._cb(fn, [out[-1], v], scopes))
                        else:
                            e = _rhai_eq(out[-1], v)
                            if isinstance(e, np.ndarray):
                                raise _PredicationUnsupported()
                            same = bool(e)
                        if same:
                            continue
                    out.append(v)
                obj[:] = out
                return UNIT
            if name == "split":
                # split the array at an index: receiver keeps the head,
                # the cut-off tail is returned
                self._need(args, 1, "split", obj)
                if isinstance(args[0], bool) or not isinstance(args[0], int):
                    raise RhaiRuntimeError(
                        f"function not found: split (array, {_type_of(args[0])})")
                at = int(args[0])
                if at < 0:
                    at = max(len(obj) + at, 0)
                at = min(at, len(obj))
                tail = obj[at:]
                del obj[at:]
                return tail
            if name == "append":
                if not isinstance(args[0], list):
                    raise RhaiRuntimeError("append() expects an array")
                obj.extend(args[0])  # args were cloned on entry
                return UNIT
            if name == "pad":
                target = int(args[0])
                while len(obj) < target:
                    self.tick()
                    obj.append(_rhai_copy(args[1]))
                return UNIT
        if isinstance(obj, dict):
            if name == "keys":
                return sorted(obj.keys())  # BTreeMap order
            if name == "values":
                return [obj[k] for k in sorted(obj)]
            if name == "contains":
                return args[0] in obj
            if name == "remove":
                return obj.pop(args[0], UNIT)
            if name == "len":
                return len(obj)
            if name == "get":
                return _rhai_copy(obj.get(args[0], UNIT))
            if name == "set":
                obj[args[0]] = args[1]  # args were cloned on entry
                return UNIT
            if name == "mixin":
                if not isinstance(args[0], dict):
                    raise RhaiRuntimeError("mixin() expects a map")
                obj.update(args[0])  # rhs wins, like the '+' merge
                return UNIT
            if name == "fill_with":
                # like mixin but only fills in MISSING keys
                if not isinstance(args[0], dict):
                    raise RhaiRuntimeError("fill_with() expects a map")
                for k, v in args[0].items():
                    obj.setdefault(k, v)
                return UNIT
            if name == "to_json":
                return _to_json(obj)
            if name == "clear":
                obj.clear()
                return UNIT
            if name == "is_empty":
                return len(obj) == 0
        if isinstance(obj, str):
            if name == "len":
                return len(obj)
            if name == "is_empty":
                return len(obj) == 0
            if name == "to_upper":
                return obj.upper()
            if name == "to_lower":
                return obj.lower()
            if name == "contains":
                return args[0] in obj
            if name == "starts_with":
                return obj.startswith(args[0])
            if name == "ends_with":
                return obj.endswith(args[0])
            if name == "index_of":
                start = int(args[1]) if len(args) > 1 else 0
                return obj.find(args[0], start)
            if name == "sub_string":
                if isinstance(args[0], RhaiRange):
                    lo, hi = _str_span(obj, args)
                    return obj[lo:hi]
                start = int(args[0])
                if start < 0:
                    start = max(len(obj) + start, 0)
                if len(args) > 1:
                    return obj[start : start + max(int(args[1]), 0)]
                return obj[start:]
            if name == "chars":
                # iterator over chars; (start[, len]) restricts the span.
                # Returned as an array of 1-char strings (this engine's
                # char model), which the for loop iterates.
                if args:
                    lo, hi = _str_span(obj, args)
                    return list(obj[lo:hi])
                return list(obj)
            if name == "to_chars":
                return list(obj)
            if name == "to_int" and len(obj) == 1:
                # char -> unicode codepoint (chars are 1-char strings here)
                return ord(obj)
            if name == "split":
                if not args:
                    return obj.split()
                if isinstance(args[0], int):
                    at = args[0]
                    return [obj[:at], obj[at:]]
                return obj.split(args[0])
            if name == "split_rev":
                # segments from the END of the string (string_more)
                self._need(args, 1, "split_rev", obj)
                if not isinstance(args[0], str):
                    raise RhaiRuntimeError(
                        f"function not found: split_rev (string, "
                        f"{_type_of(args[0])})")
                return list(reversed(obj.split(args[0])))
            if name == "parse_int":
                # Rust i64::from_str_radix semantics (Rhai's parse_int):
                # optional sign then digits of the radix — no whitespace,
                # no underscores, no 0x prefixes; overflow is an error
                radix = int(args[0]) if args else 10
                if radix < 2 or radix > 36:
                    raise RhaiRuntimeError(
                        f"parse_int(): invalid radix {radix}")
                body = obj[1:] if obj[:1] in ("+", "-") else obj
                try:
                    if not body or not body.isascii():
                        # Rust from_str_radix is ASCII-only; Python's
                        # int() accepts Unicode digit classes
                        raise ValueError("empty or non-ascii")
                    for ch in body:
                        int(ch, radix)  # rejects '_', 'x', whitespace...
                    v = int(obj, radix)
                except ValueError:
                    raise RhaiRuntimeError(
                        f"Error parsing integer number '{obj}'")
                if v < _I64_MIN or v > _I64_MAX:
                    raise RhaiRuntimeError(
                        f"Error parsing integer number '{obj}': "
                        "number too large to fit in a 64-bit integer")
                return v
            if name == "parse_float":
                # Rust f64 FromStr: inf/infinity/NaN accepted, but not
                # Python's extra leniency (surrounding whitespace,
                # digit-group underscores, Unicode digit classes)
                if obj != obj.strip() or "_" in obj or not obj.isascii():
                    raise RhaiRuntimeError(
                        f"Error parsing floating-point number '{obj}'")
                try:
                    return float(obj)
                except ValueError:
                    raise RhaiRuntimeError(
                        f"Error parsing floating-point number '{obj}'")
            if name in _STRING_INPLACE:
                # receiver was a temporary (not a variable): mutate the
                # copy and discard, like Rhai — but still arity-check
                _string_inplace(obj, name, args)
                return UNIT
            if name in _STRING_INPLACE_RET:
                # temporaries: the mutation is discarded, the value kept
                return _string_inplace_ret(obj, name, args)[1]
        if isinstance(obj, float) or isinstance(obj, int):
            if name == "abs":
                if isinstance(obj, int) and obj == _I64_MIN:
                    raise RhaiRuntimeError(f"integer overflow: abs({obj})")
                return abs(obj)
            if name == "floor":
                # f64::floor returns f64 (reference registers floor(f64)->f64
                # at scripting.rs:1283; Rhai std's floor is float-typed too);
                # INT receivers keep the permissive int pass-through
                return float(math.floor(obj)) if isinstance(obj, float) else obj
            if name in ("ceil", "ceiling"):
                return float(math.ceil(obj)) if isinstance(obj, float) else obj
            if name == "int":
                # integral part, as float (f64::trunc)
                return float(math.trunc(obj)) if isinstance(obj, float) else obj
            if name == "fraction":
                if isinstance(obj, float):
                    return obj - float(math.trunc(obj))
                return 0 if isinstance(obj, int) else obj
            if name == "to_degrees":
                return math.degrees(float(obj))
            if name == "to_radians":
                return math.radians(float(obj))
            if name == "is_nan":
                return isinstance(obj, float) and obj != obj
            if name == "is_infinite":
                return isinstance(obj, float) and math.isinf(obj)
            if name == "is_finite":
                return not isinstance(obj, float) or math.isfinite(obj)
            if name == "is_zero":
                return obj == 0
            if name == "sign":
                # sign as INT: -1/0/+1 (NaN compares false on both sides -> 0)
                return -1 if obj < 0 else (1 if obj > 0 else 0)
            if isinstance(obj, int) and not isinstance(obj, bool):
                if name == "is_odd":
                    return obj % 2 != 0
                if name == "is_even":
                    return obj % 2 == 0
                if name in ("to_hex", "to_octal", "to_binary"):
                    # Rust {:x}/{:o}/{:b} on i64 format the two's-complement
                    # bit pattern for negatives
                    v = obj & _I64_MASK if obj < 0 else obj
                    spec = {"to_hex": "x", "to_octal": "o", "to_binary": "b"}
                    return format(v, spec[name])
            if name == "round":
                # f64::round, half away from zero — via the EXACT fraction
                # (x - floor(x) is exact in f64); floor(x+0.5) rounds up
                # across the boundary at x = 0.5 - 2^-54
                x = float(obj)
                if x != x or math.isinf(x):
                    return x
                f = float(math.floor(abs(x)))
                r = f + 1.0 if abs(x) - f >= 0.5 else f
                return r if x >= 0 else -r
            if name == "sqrt":
                # f64::sqrt: negative -> NaN, never a host ValueError
                return math.sqrt(obj) if obj >= 0 else float("nan")
            if name == "to_int":
                if isinstance(obj, float):
                    # checked f64 -> i64 (Rhai math_basic): past-range
                    # floats error, in-range truncate, NaN -> 0 (Rust `as`)
                    if obj != obj:
                        return 0
                    if obj > float(_I64_MAX) or obj < float(_I64_MIN):
                        raise RhaiRuntimeError(
                            f"integer overflow: to_int({obj})")
                    return min(max(int(obj), _I64_MIN), _I64_MAX)
                return int(obj)
            if name == "to_float":
                return float(obj)
            if name == "to_string":
                return to_display(obj)
        if name == "to_string":
            return to_display(obj)
        if name == "type_of":
            return _type_of(obj)
        if name == "to_debug":
            return _debug_display(obj)
        if isinstance(obj, Timestamp) and name == "elapsed":
            import time

            return time.monotonic() - obj.t
        # Rhai treats method-call and function-call styles as one notation:
        # `x.f(y)` falls back to the native function `f(x, y)` (host fns
        # only — script fns bind `this` instead of the first parameter).
        # ndarray receivers keep the strict path so the bulk vectorizer's
        # bail-to-scalar semantics are unchanged.
        if not isinstance(obj, np.ndarray):
            fn = self.host_fns.get(name)
            if fn is not None:
                call_args = [obj] + list(args if args is not None else [])
                try:
                    return fn(*call_args)
                except TypeError as e:
                    import inspect

                    try:
                        inspect.signature(fn).bind(*call_args)
                    except TypeError:
                        pass  # wrong arity: report unknown-method below
                    else:
                        raise e
        raise RhaiRuntimeError(f"unknown method '{name}' on {type(obj).__name__}")
