"""Rhai AST -> Python transpiler: the fast path for closure-free scripts.

The reference embeds Rhai 1.25 as a native AST interpreter
(src/ops/scripting.rs:284-317); general scripts there run at native
interpreter speed.  Our tree-walker (interp.py) pays Python dispatch per
AST node (~0.15M loop-iters/s measured).  This module compiles the SAME
parsed AST to Python source once per script and runs it through CPython's
bytecode VM instead — loops/branches/try-catch become native control
flow, variables become Python locals (a static renaming pass reproduces
Rhai's block scoping and shadowing exactly), while operators and methods
dispatch through the very same `Interpreter._binop` /
`Interpreter._method` the tree-walker uses — or through exact-typed
scalar fast paths (_make_fast_binops) that reproduce _binop's scalar
branches bit-for-bit — so numeric semantics (i64 truncating division,
shift bounds, string coercion, ...) are identical by construction.
Measured 7-12x on a 1M-iteration arithmetic loop (0.16 -> 1.9M iters/s
on the bench rig; `python bench.py --scripts` reproduces).

Scope of the fast path: scripts WITHOUT closures.  Closures are the
domain of the bulk vectorizer (api.py `for_each_pixel` etc.), which
introspects Closure ASTs — those scripts keep the tree-walker.  Any
construct this compiler does not understand raises TranspileUnsupported
at compile time and the engine silently falls back, so the tree-walker
remains the semantic oracle (tests/test_pycompile.py runs both engines
on the conformance corpus and compares).

Known (accepted) divergences from the tree-walker, all unreachable
without closures or pathological aliasing:
- An FnPtr whose name refers to a scope VARIABLE holding another
  FnPtr/Closure resolves to user/host functions only.
- The operation budget ticks once per statement and loop iteration
  rather than per AST node; the 50M cap still bounds runaway scripts
  (the reference's own op accounting differs from both).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

from paintfe_tpu_torch.scripting import interp as I
from paintfe_tpu_torch.scripting.rhai_ast import parse


class TranspileUnsupported(Exception):
    """Construct outside the fast path (closures, future syntax)."""


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


_LOOP_KINDS = ("while", "loop", "dowhile", "for")


def _loop_carries_value(stmt) -> bool:
    """True when a loop statement contains a `break value` that binds to
    THIS loop (not to a nested one, closure, or fn)."""

    def walk(n):
        if not isinstance(n, (tuple, list)):
            return False
        if isinstance(n, tuple) and n:
            if n[0] == "break":
                return len(n) > 1 and n[1] is not None
            if n[0] in _LOOP_KINDS or n[0] in ("closure", "fn", "stmtexpr"):
                return False  # inner breaks bind to the inner construct
        return any(walk(x) for x in n)

    body_idx = {"while": 2, "loop": 1, "dowhile": 2, "for": 3}[stmt[0]]
    return walk(stmt[body_idx])


class _Compiler:
    def __init__(self, closure_mode: bool = False):
        self.lines: List[str] = []
        self.indent = 1
        self.uid = 0
        # scope stack of {rhai name -> python name}; scopes[0] is top level
        self.scopes: List[dict] = [{}]
        self.toplevel = self.scopes[0]
        self.fn_depth = 0          # inside a user fn body?
        self.fn_assigned: Optional[set] = None  # outer pynames written in fn
        self.dowhile_direct = 0    # compiling a dowhile's direct body?
        self.closure_mode = closure_mode
        self.const_py: set = set()  # pynames currently bound by `const`

    @staticmethod
    def copy_free(e) -> bool:
        """True when the expression's value can never be a list/map, so
        Rhai's clone-on-assign (_rhai_copy) is statically the identity.
        Binops other than '+' cannot yield containers (interp's '+' is the
        only list-concatenating operator; the rest error or stay scalar /
        ndarray, both of which _rhai_copy passes through)."""
        k = e[0]
        if k in ("int", "float", "str", "bool", "unit", "tstr", "and", "or",
                 "range", "un"):
            return True
        return k == "bin" and e[1] != "+"

    # -- emit helpers -------------------------------------------------------

    def emit(self, line: str):
        self.lines.append("    " * self.indent + line)

    def tmp(self) -> str:
        self.uid += 1
        return f"_t{self.uid}"

    def mangle(self, name: str) -> str:
        self.uid += 1
        return f"v{self.uid}_{name}"

    # -- scoping ------------------------------------------------------------

    def declare(self, name: str) -> str:
        scope = self.scopes[-1]
        if scope is self.toplevel and name in scope:
            return scope[name]  # top-level re-let overwrites (globals dict)
        py = self.mangle(name)
        scope[name] = py
        return py

    def resolve(self, name: str) -> Optional[str]:
        if self.fn_depth:
            # user fns see only [globals, local]: params/fn-locals (scopes
            # above fn base) then top level — never enclosing block scopes
            for scope in reversed(self.scopes[self.fn_base:]):
                if name in scope:
                    return scope[name]
            return self.toplevel.get(name)
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return None

    def note_assign(self, py: str):
        if (self.fn_assigned is not None
                and py in self.toplevel.values()
                and all(py not in s.values()
                        for s in self.scopes[self.fn_base:])):
            self.fn_assigned.add(py)

    # -- program ------------------------------------------------------------

    def compile_program(self, ast) -> str:
        assert ast[0] == "block"
        self.emit("_fns = _rt.fns")
        self.emit("_tick = _rt.interp.tick")
        # Pre-allocate every direct top-level let/const name so user fns
        # (which see the globals scope at CALL time, not lexically) can
        # reference and nonlocal-write names declared later in the file.
        # A read before the let leaves the Python local unbound; the
        # UnboundLocalError handlers below restore the interp's
        # "variable 'x' not found" error.
        for s in ast[1]:
            if s[0] in ("let", "const") and s[1] not in self.toplevel:
                self.toplevel[s[1]] = self.mangle(s[1])
        # record top-level consts BEFORE fn bodies compile (hoisted fns
        # assigning a const global must raise like the tree-walker); a
        # later top-level `let` of the same name un-consts it in source
        # order via compile_stmt.  A name that is BOTH const and re-let at
        # top level is time-dependent (const-ness at the fn CALL site):
        # statically undecidable here, so fn-body writes to it bail.
        const_names = {s[1] for s in ast[1] if s[0] == "const"}
        let_names = {s[1] for s in ast[1] if s[0] == "let"}
        self.const_ambiguous = {self.toplevel[n]
                                for n in const_names & let_names}
        for n in const_names - let_names:
            self.const_py.add(self.toplevel[n])
        # hoist top-level fn declarations (interp.run does the same)
        fn_stmts = [s for s in ast[1] if s[0] == "fn"]
        arities: dict = {}
        for s in fn_stmts:
            if len(s[2]) != arities.setdefault(s[1], len(s[2])):
                # Rhai script fns overload by ARITY; `_fns` here is keyed
                # by name only, so such programs keep the tree-walker
                raise TranspileUnsupported("fn arity overload")
        for s in fn_stmts:
            self.compile_fn(s)
        self.emit("try:")
        self.indent += 1
        body_emitted = False
        for s in ast[1]:
            if s[0] == "fn":
                continue  # already hoisted; re-execution re-registers, a
                # no-op for identical defs (matches interp re-hoist)
            self.compile_stmt(s)
            body_emitted = True
        if not body_emitted:
            self.emit("pass")
        self.indent -= 1
        self.emit("except _Throw as _unc:")
        self.emit("    raise RhaiRuntimeError('Runtime error: ' + _D(_unc.value))")
        self.emit("except _Return:")
        self.emit("    pass  # global-level return ends the script (Rhai)")
        self.emit("except (UnboundLocalError, NameError) as _unb:")
        self.emit("    raise _uerr(_unb)")
        return "\n".join(self.lines)

    # -- statements ---------------------------------------------------------

    def compile_stmt(self, s):
        kind = s[0]
        if kind in ("let", "const"):
            val = self.expr(s[2])
            py = self.declare(s[1])
            # const-ness attaches to the binding; a re-let (same pyname at
            # top level) un-consts it, in source order
            if kind == "const":
                self.const_py.add(py)
            else:
                self.const_py.discard(py)
            if self.copy_free(s[2]):
                self.emit(f"{py} = {val}")
            else:
                self.emit(f"{py} = _copy({val})")
            return
        if kind == "fn":
            if self.closure_mode:
                raise TranspileUnsupported("fn inside closure")
            self.compile_fn(s)
            return
        if kind == "assign":
            self.compile_assign(s[1], s[2], s[3])
            return
        if kind == "expr":
            v = self.expr(s[1])
            self.emit(f"_void = {v}")
            return
        if kind == "while":
            self.emit("while True:")
            self.indent += 1
            self.emit("_tick()")
            cond = self.expr(s[1])
            self.emit(f"if not _T({cond}): break")
            self.block(s[2], loop_body=True)
            self.indent -= 1
            return
        if kind == "loop":
            self.emit("while True:")
            self.indent += 1
            self.emit("_tick()")
            self.block(s[1], loop_body=True)
            self.indent -= 1
            return
        if kind == "dowhile":
            _, cond_e, body, is_until = s
            self.emit("while True:")
            self.indent += 1
            self.emit("_tick()")
            # `continue` in the DIRECT body must still reach the condition
            # (interp catches _Continue and falls through); nested loops
            # keep native break/continue
            self.emit("try:")
            self.indent += 1
            self.dowhile_direct += 1
            self.block(body, loop_body=False)
            self.dowhile_direct -= 1
            self.indent -= 1
            self.emit("except _Break: break")
            self.emit("except _Continue: pass")
            cond = self.expr(cond_e)
            if is_until:
                self.emit(f"if _T({cond}): break")
            else:
                self.emit(f"if not _T({cond}): break")
            self.indent -= 1
            return
        if kind == "for":
            var, it_e, body = s[1], s[2], s[3]
            it = self.expr(it_e)
            itv = self.tmp()
            self.emit(f"{itv} = _forit({it})")
            self.scopes.append({})
            if isinstance(var, tuple):
                # `for (v, i) in it`: enumerate yields (counter, value);
                # the parser rejects duplicate names, so binding order
                # cannot matter
                vpy = self.declare(var[0])
                ipy = self.declare(var[1])
                self.emit(f"for {ipy}, {vpy} in enumerate({itv}):")
            else:
                py = self.declare(var)
                self.emit(f"for {py} in {itv}:")
            self.indent += 1
            self.emit("_tick()")
            self.block(body, loop_body=True, no_scope=False)
            self.indent -= 1
            self.scopes.pop()
            return
        if kind == "break":
            if len(s) > 1 and s[1] is not None:
                # break VALUE: in statement position the loop's value is
                # discarded, but the expression's side effects must run
                # (value-position loops bail to the tree-walker entirely)
                v = self.expr(s[1])
                self.emit(f"_void = {v}")
            self.emit("raise _Break()" if self.dowhile_direct else "break")
            return
        if kind == "continue":
            self.emit("raise _Continue()" if self.dowhile_direct
                      else "continue")
            return
        if kind == "return":
            v = "UNIT" if s[1] is None else self.expr(s[1])
            if self.fn_depth:
                self.emit(f"return {v}")
            else:
                self.emit(f"raise _Return({v})")
            return
        if kind == "throw":
            v = "UNIT" if s[1] is None else self.expr(s[1])
            self.emit(f"raise _Throw({v})")
            return
        if kind == "try":
            _, body, var, catcher = s
            cf = self.tmp()
            ev = self.tmp()
            self.emit(f"{cf} = False")
            self.emit("try:")
            self.indent += 1
            self.block(body)
            self.indent -= 1
            # order mirrors interp: system errors re-raise; _Throw catches
            # its value; runtime errors catch as their message (incl.
            # use-before-let reads, which surface as UnboundLocalError in
            # compiled code)
            self.emit("except RhaiSystemError: raise")
            self.emit(f"except _Throw as _ex: {ev} = _ex.value; {cf} = True")
            self.emit(f"except RhaiRuntimeError as _ex: "
                      f"{ev} = _ex.message; {cf} = True")
            self.emit(f"except (UnboundLocalError, NameError) as _ex: "
                      f"{ev} = _uerr(_ex).message; {cf} = True")
            self.emit(f"if {cf}:")
            self.indent += 1
            self.scopes.append({})
            if var:
                py = self.declare(var)
                self.emit(f"{py} = {ev}")
            self.block(catcher, no_scope=False)
            self.scopes.pop()
            self.indent -= 1
            return
        raise TranspileUnsupported(f"statement {kind}")

    def block(self, blk, loop_body=False, no_scope=True):
        """Compile a block's statements in a fresh scope.  `loop_body` is
        informational only (native break/continue already scope to the
        nearest Python loop, same as the interp's per-loop exception
        handlers)."""
        assert blk[0] == "block"
        if no_scope:
            self.scopes.append({})
        emitted = False
        dd = self.dowhile_direct
        if loop_body:
            self.dowhile_direct = 0  # nested loop bodies are native again
        for st in blk[1]:
            self.compile_stmt(st)
            emitted = True
        self.dowhile_direct = dd
        if not emitted:
            self.emit("pass")
        if no_scope:
            self.scopes.pop()

    def block_value(self, blk, out_py: str):
        """Block as expression: value = last bare (no-semicolon) expression
        statement, else UNIT (interp.exec_block + exec_stmt 'expr')."""
        assert blk[0] == "block"
        self.scopes.append({})
        stmts = blk[1]
        self.emit(f"{out_py} = UNIT")
        for i, st in enumerate(stmts):
            if i == len(stmts) - 1 and st[0] == "expr" and not st[2]:
                v = self.expr(st[1])
                self.emit(f"{out_py} = {v}")
            else:
                if (i == len(stmts) - 1
                        and st[0] in ("while", "loop", "dowhile", "for")
                        and _loop_carries_value(st)):
                    # a trailing loop whose break CARRIES a value makes it
                    # the block's value — only the tree-walker threads
                    # that (value-less trailing loops yield UNIT in both)
                    raise TranspileUnsupported("loop value")
                self.compile_stmt(st)
        self.scopes.pop()

    def compile_fn(self, s):
        _, name, params, body = s
        fnpy = self.mangle(f"fn_{name}")
        outer_scopes = self.scopes
        outer_base = getattr(self, "fn_base", None)
        outer_assigned = self.fn_assigned
        outer_dowhile = self.dowhile_direct
        self.dowhile_direct = 0
        self.scopes = [self.toplevel, {}]
        self.fn_base = 1
        self.fn_depth += 1
        self.fn_assigned = set()
        ppys = []
        for p in params:
            self.scopes[-1][p] = self.mangle(p)
            ppys.append(self.scopes[-1][p])
        hdr = len(self.lines)
        self.emit(f"def {fnpy}({', '.join(ppys)}):")
        self.indent += 1
        nonlocal_at = len(self.lines)  # placeholder position
        self.emit("_ip = _rt.interp")
        self.emit("_ip.depth += 1")
        self.emit("if _ip.depth > _MAXDEPTH:")
        self.emit("    _ip.depth -= 1")
        self.emit("    raise RhaiSystemError('maximum call depth exceeded')")
        self.emit("try:")
        self.indent += 1
        for p in ppys:
            self.emit(f"{p} = _copy({p})")
        rv = self.tmp()
        self.block_value(body, rv)
        self.emit(f"return {rv}")
        self.indent -= 1
        self.emit("finally:")
        self.emit("    _ip.depth -= 1")
        if self.fn_assigned:
            decl = ("    " * self.indent
                    + "nonlocal " + ", ".join(sorted(self.fn_assigned)))
            self.lines.insert(nonlocal_at, decl)
        self.indent -= 1
        self.emit(f"_fns[{name!r}] = {fnpy}")
        self.fn_depth -= 1
        self.fn_assigned = outer_assigned
        self.dowhile_direct = outer_dowhile
        self.scopes = outer_scopes
        if outer_base is None:
            del self.fn_base
        else:
            self.fn_base = outer_base

    def compile_assign(self, target, op, rhs_e):
        rhs = self.expr(rhs_e)
        val = self.tmp()
        if self.copy_free(rhs_e):
            self.emit(f"{val} = {rhs}")
        else:
            self.emit(f"{val} = _copy({rhs})")
        if target[0] == "var":
            py = self.resolve(target[1])
            if py is None:
                if self.closure_mode:
                    self.emit(f"_dynset({target[1]!r}, {op!r}, {val})")
                else:
                    self.emit(f"_nf({target[1]!r})")
                return
            if self.fn_depth and py in getattr(self, "const_ambiguous", ()):
                # const-ness of this global depends on WHEN the fn is
                # called (const + re-let at top level): only the
                # tree-walker tracks that
                raise TranspileUnsupported("assignment to sometimes-const")
            if py in self.const_py:
                self.emit(f"_cerr({target[1]!r})")
                return
            self.note_assign(py)
            if op == "=":
                if py in self.toplevel.values():
                    # Pre-allocated top-level name: a plain store before its
                    # `let` has run must still raise "variable not found"
                    # like the interp, so read it first (compound ops read
                    # anyway; the UnboundLocalError handler maps the error).
                    self.emit(f"{py}")
                self.emit(f"{py} = {val}")
            else:
                h = _BIN_HELPERS.get(op[:-1])
                if h is not None:
                    self.emit(f"{py} = {h}({py}, {val})")
                else:
                    self.emit(f"{py} = _B({op[:-1]!r}, {py}, {val})")
            return
        if target[0] == "index":
            obj = self.expr(target[1])
            ot = self.tmp()
            self.emit(f"{ot} = {obj}")
            idx = self.expr(target[2])
            it = self.tmp()
            self.emit(f"{it} = {idx}")
            writable = (target[1][0] in ("var", "index")
                        or (target[1][0] == "method"
                            and target[1][3] is None))
            if writable:
                # strings support char set-by-index (Rhai); immutable
                # host-side, so rebuild and write back to the base
                self.emit(f"if isinstance({ot}, str):")
                self.indent += 1
                res = self.tmp()
                self.emit(f"{res} = _ssi({ot}, {it}, {op!r}, {val})")
                self.compile_assign_value(target[1], res)
                self.indent -= 1
                self.emit("else:")
                self.indent += 1
                self.emit(f"_ai({ot}, {it}, {op!r}, {val})")
                self.indent -= 1
            else:
                self.emit(f"_ai({ot}, {it}, {op!r}, {val})")
            return
        if target[0] == "method" and target[3] is None:
            obj = self.expr(target[1])
            self.emit(f"_ap({obj}, {target[2]!r}, {op!r}, {val})")
            return
        raise TranspileUnsupported("assignment target")

    # -- expressions --------------------------------------------------------

    def expr(self, e) -> str:
        kind = e[0]
        if kind == "int" or kind == "float":
            return repr(e[1])
        if kind == "bool":
            return "True" if e[1] else "False"
        if kind == "str":
            return repr(e[1])
        if kind == "unit":
            return "UNIT"
        if kind == "tstr":
            parts = []
            for pk, payload in e[1]:
                if pk == "lit":
                    parts.append(repr(payload))
                else:
                    # the DISPLAY conversion must be pinned at this part's
                    # evaluation point, not deferred to the final concat: a
                    # later `${a.remove(...)}` part may mutate a container
                    # an earlier `${a}` part captured by reference (interp
                    # converts each part to a string immediately)
                    t = self.tmp()
                    self.emit(f"{t} = _D({self.expr_t(payload)})")
                    parts.append(t)
            return "(" + " + ".join(parts) + ")" if parts else "''"
        if kind == "var":
            py = self.resolve(e[1])
            if py is not None:
                return py
            if self.closure_mode:
                # the captured chain can gain names between calls (the
                # growing globals dict): dynamic walk, interp semantics
                return f"_dyn({e[1]!r})"
            return f"_nf({e[1]!r})"
        if kind == "array":
            return "[" + ", ".join(self.expr_t(x) for x in e[1]) + "]"
        if kind == "map":
            items = ", ".join(f"{k!r}: {self.expr_t(v)}" for k, v in e[1])
            return "{" + items + "}"
        if kind == "range":
            lo = self.expr_t(e[1])
            hi = self.expr_t(e[2])
            return f"RhaiRange(int({lo}), int({hi}), {e[3]!r})"
        if kind == "bin":
            lt = self.expr_t(e[2])  # temps force l-then-r side-effect order
            rt = self.expr_t(e[3])
            h = _BIN_HELPERS.get(e[1])
            if h is not None:
                return f"{h}({lt}, {rt})"
            return f"_B({e[1]!r}, {lt}, {rt})"
        if kind == "un":
            v = self.expr(e[2])
            if e[1] == "-":
                return f"_Bneg({v})"
            if e[1] == "!":
                return f"(not _T({v}))"
            raise TranspileUnsupported(f"unary {e[1]}")
        if kind == "and":
            out = self.tmp()
            l = self.expr(e[1])
            self.emit(f"{out} = _T({l})")
            self.emit(f"if {out}:")
            self.indent += 1
            r = self.expr(e[2])
            self.emit(f"{out} = _T({r})")
            self.indent -= 1
            return out
        if kind == "or":
            out = self.tmp()
            l = self.expr(e[1])
            self.emit(f"{out} = _T({l})")
            self.emit(f"if not {out}:")
            self.indent += 1
            r = self.expr(e[2])
            self.emit(f"{out} = _T({r})")
            self.indent -= 1
            return out
        if kind == "if":
            out = self.tmp()
            c = self.expr(e[1])
            self.emit(f"if _T({c}):")
            self.indent += 1
            self.block_value(e[2], out)
            self.indent -= 1
            self.emit("else:")
            self.indent += 1
            if e[3] is not None:
                self.block_value(e[3], out)
            else:
                self.emit(f"{out} = UNIT")
            self.indent -= 1
            return out
        if kind == "block":
            out = self.tmp()
            self.block_value(e, out)
            return out
        if kind == "switch":
            return self.compile_switch(e)
        if kind == "index":
            ot = self.expr_t(e[1])
            it = self.expr_t(e[2])
            return f"_ix({ot}, {it})"
        if kind == "call":
            name = e[1]
            if name in ("is_def_var", "eval"):
                # these need a live scope only the tree-walker has
                raise TranspileUnsupported(name)
            args = self.arglist(e[2])
            py = self.resolve(name)
            if py is not None:
                if py in self.toplevel.values():
                    # a pre-allocated top-level name may be UNBOUND at call
                    # time (call before its let): interp then falls through
                    # to fn resolution rather than erroring — guard it
                    t = self.tmp()
                    self.emit("try:")
                    self.emit(f"    {t} = {py}")
                    self.emit("except (UnboundLocalError, NameError):")
                    self.emit(f"    {t} = _UNB")
                    return f"_cvg({t}, {name!r}, {args})"
                return f"_cv({py}, {args}, {name!r})"
            return f"_cn({name!r}, {args})"
        if kind == "method":
            return self.compile_method(e)
        if kind == "closure":
            raise TranspileUnsupported("closure")
        raise TranspileUnsupported(f"expression {kind}")

    def expr_t(self, e) -> str:
        """Compile to a temp, pinning this subexpression's side effects to
        the current point in the statement stream (interp evaluates
        children strictly left-to-right)."""
        v = self.expr(e)
        # only value-stable atoms skip the temp: variables must be
        # snapshotted (a later sibling user-fn call can mutate them
        # through nonlocal before the combined expression evaluates)
        if v.startswith("_t") and v[2:].isdigit() or v in ("UNIT", "True",
                                                           "False"):
            return v
        t = self.tmp()
        self.emit(f"{t} = {v}")
        return t

    def arglist(self, arg_exprs) -> str:
        return "[" + ", ".join(self.expr_t(a) for a in arg_exprs) + "]"

    def compile_switch(self, e) -> str:
        _, subj_e, arms, default = e
        out = self.tmp()
        st = self.expr_t(subj_e)
        self.emit(f"{out} = UNIT")
        done = self.tmp()
        self.emit(f"{done} = False")
        for pats, guard, body in arms:
            # patterns are evaluated lazily in order until one matches
            self.emit(f"if not {done}:")
            self.indent += 1
            hit = self.tmp()
            if pats is None:  # guarded `_` arm: always pattern-matches
                self.emit(f"{hit} = True")
            else:
                self.emit(f"{hit} = False")
                for pat in pats:
                    self.emit(f"if not {hit}:")
                    self.indent += 1
                    pv = self.expr(pat)
                    self.emit(f"{hit} = _swm({st}, {pv})")
                    self.indent -= 1
            if guard is not None:
                # case condition: evaluated only when the pattern matched;
                # false falls through to the NEXT arm (mirrors the interp)
                self.emit(f"if {hit}:")
                self.indent += 1
                gv = self.expr(guard)
                self.emit(f"{hit} = _T({gv})")
                self.indent -= 1
            self.emit(f"if {hit}:")
            self.indent += 1
            self.emit(f"{done} = True")
            if body[0] == "block":
                self.block_value(body, out)
            else:
                v = self.expr(body)
                self.emit(f"{out} = {v}")
            self.indent -= 1
            self.indent -= 1
        if default is not None:
            self.emit(f"if not {done}:")
            self.indent += 1
            if default[0] == "block":
                self.block_value(default, out)
            else:
                v = self.expr(default)
                self.emit(f"{out} = {v}")
            self.indent -= 1
        return out

    def compile_method(self, e) -> str:
        _, obj_e, name, arg_es = e
        obj = self.expr(obj_e)
        ot = self.tmp()
        self.emit(f"{ot} = {obj}")
        if arg_es is None:
            return f"_mc({ot}, {name!r}, None)"
        args = self.arglist(arg_es)
        writable = (obj_e[0] in ("var", "index")
                    or (obj_e[0] == "method" and obj_e[3] is None))
        if name in I._STRING_INPLACE and writable:
            # Rhai in-place string methods mutate the receiver variable
            out = self.tmp()
            self.emit(f"if isinstance({ot}, str):")
            self.indent += 1
            res = self.tmp()
            self.emit(f"{res} = _si({ot}, {name!r}, {args})")
            self.compile_assign_value(obj_e, res)
            self.emit(f"{out} = UNIT")
            self.indent -= 1
            self.emit("else:")
            self.indent += 1
            self.emit(f"{out} = _mc({ot}, {name!r}, {args})")
            self.indent -= 1
            return out
        if name in I._STRING_INPLACE_RET and writable:
            # pop(): mutates the receiver AND returns the removed chars
            out = self.tmp()
            self.emit(f"if isinstance({ot}, str):")
            self.indent += 1
            res = self.tmp()
            self.emit(f"{res} = _sir({ot}, {name!r}, {args})")
            self.compile_assign_value(obj_e, f"{res}[0]")
            self.emit(f"{out} = {res}[1]")
            self.indent -= 1
            self.emit("else:")
            self.indent += 1
            self.emit(f"{out} = _mc({ot}, {name!r}, {args})")
            self.indent -= 1
            return out
        return f"_mc({ot}, {name!r}, {args})"

    def compile_assign_value(self, target, val_py: str):
        """Plain `=` store of an already-computed value (no copy — mirrors
        interp's in-place string write-back which assigns directly)."""
        if target[0] == "var":
            py = self.resolve(target[1])
            if py is None:
                if self.closure_mode:
                    self.emit(f"_dynset({target[1]!r}, '=', {val_py})")
                else:
                    self.emit(f"_nf({target[1]!r})")
                return
            self.note_assign(py)
            self.emit(f"{py} = {val_py}")
            return
        if target[0] == "index":
            obj = self.expr(target[1])
            idx = self.expr(target[2])
            self.emit(f"_ai({obj}, {idx}, '=', {val_py})")
            return
        if target[0] == "method" and target[3] is None:
            obj = self.expr(target[1])
            self.emit(f"_ap({obj}, {target[2]!r}, '=', {val_py})")
            return
        raise TranspileUnsupported("write-back target")


# Scalar fast paths for the hot operators.  `type(x) is int/float` is an
# EXACT check (bools, numpy scalars, arrays all fall through to _binop),
# and each formula reproduces Interpreter._binop's scalar branch bit-for-
# bit: truncating i64 division, C-fmod modulo (exact for |v| <= 2^53 —
# larger ints fall through so the interp's float round-trip is kept),
# plain float arithmetic (incl. Python's ZeroDivisionError on x/0.0).
_BIN_HELPERS = {"+": "_Badd", "-": "_Bsub", "*": "_Bmul", "/": "_Bdiv",
                "%": "_Bmod", "==": "_Beq", "!=": "_Bne", "<": "_Blt",
                "<=": "_Ble", ">": "_Bgt", ">=": "_Bge"}

_F53 = 1 << 53


def _Bneg(v):
    t = type(v)
    if t is int or t is float:  # exact: bool is NOT negatable in Rhai
        if v == I._I64_MIN and t is int:
            raise I.RhaiRuntimeError(f"integer overflow: -{v}")
        return -v
    if I._cmp_class(v) != "num":
        raise I.RhaiRuntimeError(f"function not found: - ({I._type_of(v)})")
    return -v


def _swm(subject, m):
    """switch-case matcher: ranges match non-bool ints; everything else is
    Rhai same-type equality (1 never matches true)."""
    if isinstance(m, I.RhaiRange):
        hi = m.hi + 1 if m.inclusive else m.hi
        return (isinstance(subject, int)
                and not isinstance(subject, bool)
                and m.lo <= subject < hi)
    return I._rhai_eq(m, subject)


def _cerr(name):
    """Assignment to a const binding (Rhai ErrorAssignmentToConstant)."""
    raise I.RhaiRuntimeError(f"cannot assign to constant '{name}'")


def _uerr(ex):
    """UnboundLocalError/NameError on a mangled script variable -> the
    interp's 'variable not found' error (use-before-let reads)."""
    import re

    m = re.search(r"v\d+_(\w+)", str(ex))
    if m is None:
        raise ex  # not a script variable: a genuine engine bug
    return I.RhaiRuntimeError(f"variable '{m.group(1)}' not found")


def _make_fast_binops(B):
    import math

    def _num(v):
        t = type(v)
        return t is int or t is float

    _MIN, _MAX = I._I64_MIN, I._I64_MAX

    def _Badd(l, r):
        if type(l) is int and type(r) is int:
            v = l + r
            if _MIN <= v <= _MAX:  # checked i64 (Rhai default build)
                return v
            raise I.RhaiRuntimeError(f"integer overflow: {l} + {r}")
        if _num(l) and _num(r):
            return l + r
        return B("+", l, r)

    def _Bsub(l, r):
        if type(l) is int and type(r) is int:
            v = l - r
            if _MIN <= v <= _MAX:
                return v
            raise I.RhaiRuntimeError(f"integer overflow: {l} - {r}")
        if _num(l) and _num(r):
            return l - r
        return B("-", l, r)

    def _Bmul(l, r):
        if type(l) is int and type(r) is int:
            v = l * r
            if _MIN <= v <= _MAX:
                return v
            raise I.RhaiRuntimeError(f"integer overflow: {l} * {r}")
        if _num(l) and _num(r):
            return l * r
        return B("*", l, r)

    def _Bdiv(l, r):
        if type(l) is int and type(r) is int:
            if r == 0:
                raise I.RhaiRuntimeError("division by zero")
            q = abs(l) // abs(r)
            q = q if (l >= 0) == (r >= 0) else -q
            if q > _MAX:  # only i64::MIN / -1
                raise I.RhaiRuntimeError(f"integer overflow: {l} / {r}")
            return q
        if _num(l) and _num(r):
            if r == 0:
                # IEEE inf/NaN corner: route through the interp (Python's
                # `/` raises ZeroDivisionError; Rhai f64 yields inf/NaN)
                return B("/", l, r)
            return l / r
        return B("/", l, r)

    def _Bmod(l, r):
        if (type(l) is int and type(r) is int
                and -_F53 <= l <= _F53 and -_F53 <= r <= _F53):
            if r == 0:
                raise I.RhaiRuntimeError("modulo by zero")
            rem = abs(l) % abs(r)
            return rem if l >= 0 else -rem
        if type(l) is float or type(r) is float:
            # math.fmod raises on a zero divisor or non-finite numerator
            # where np.fmod (the interp path) yields nan — route those
            # corners through the interp
            if _num(l) and _num(r) and r != 0 and math.isfinite(l):
                return math.fmod(l, r)
        # large ints / i64::MIN % -1 / non-numbers: the interp's exact
        # integer path (with the checked_rem overflow) handles them
        return B("%", l, r)

    def _cmp(name, pyop):
        def f(l, r, _B=B):
            if _num(l) and _num(r):
                return pyop(l, r)
            return _B(name, l, r)
        return f

    import operator as _op

    return {
        "_Badd": _Badd, "_Bsub": _Bsub, "_Bmul": _Bmul, "_Bdiv": _Bdiv,
        "_Bmod": _Bmod,
        "_Beq": _cmp("==", _op.eq), "_Bne": _cmp("!=", _op.ne),
        "_Blt": _cmp("<", _op.lt), "_Ble": _cmp("<=", _op.le),
        "_Bgt": _cmp(">", _op.gt), "_Bge": _cmp(">=", _op.ge),
    }


# ---------------------------------------------------------------------------
# Runtime: helpers bound to one Interpreter instance
# ---------------------------------------------------------------------------


_UNBOUND = object()  # a top-level name not yet let-bound at call time


class _Runtime:
    def __init__(self, interp: I.Interpreter):
        self.interp = interp
        self.fns = {}


def _make_env(rt: _Runtime) -> dict:
    interp = rt.interp
    host = interp.host_fns
    fns = rt.fns
    # alias the live dict so interp.call_function (FnPtr deref inside std
    # array callbacks, closure-env _cn) resolves transpiled fns too
    interp.compiled_fns = fns
    B = interp._binop

    def _nf(name):
        raise I.RhaiRuntimeError(f"variable '{name}' not found")

    def _forit(v):
        if isinstance(v, (I.RhaiRange, I.StepRange)):
            return v
        if isinstance(v, list):
            # Rhai for-in yields cloned values over a snapshot (matches
            # the tree-walker's loop binding)
            return [I._rhai_copy(x) for x in v]
        if isinstance(v, str):
            return list(v)  # Rhai iterates strings by char
        raise I.RhaiRuntimeError("for loop needs a range or array")

    def _ix(obj, idx):
        try:
            return obj[idx]
        except (IndexError, TypeError, KeyError) as exc:
            raise I.RhaiRuntimeError(f"index error: {exc}")

    def _ai(obj, idx, op, value):
        if isinstance(obj, dict):
            if op != "=":
                value = B(op[:-1], obj.get(idx, I.UNIT), value)
            obj[idx] = value
            return
        if not isinstance(obj, list):
            raise I.RhaiRuntimeError("indexed assignment needs an array or map")
        if op != "=":
            value = B(op[:-1], obj[idx], value)
        obj[idx] = value

    def _ap(obj, key, op, value):
        if isinstance(obj, dict):
            if op != "=":
                value = B(op[:-1], obj.get(key, I.UNIT), value)
            obj[key] = value
            return
        raise I.RhaiRuntimeError("property assignment needs a map")

    def _cn(name, args):
        # resolution order mirrors interp.call_function (minus the scope
        # walk, which the compiler resolved statically via _cv)
        if name == "Fn":
            if len(args) != 1 or not isinstance(args[0], str):
                raise I.RhaiRuntimeError("Fn() expects one string argument")
            return I.FnPtr(args[0])
        if name == "type_of" and len(args) == 1 and "type_of" not in host:
            return I._type_of(args[0])
        if name == "eval":
            # only reachable via Fn("eval"): direct eval calls bail to the
            # tree-walker at compile time (compile_call)
            raise I.RhaiRuntimeError(
                "eval is not available through function pointers")
        f = fns.get(name)
        if f is not None:
            if f.__code__.co_argcount != len(args):
                raise I.RhaiRuntimeError(
                    f"function '{name}' expects {f.__code__.co_argcount} args")
            return f(*args)
        hf = host.get(name)
        if hf is None:
            r = I._std_free_call(interp, name, args)
            if r is not I._NOMATCH:
                return r
            # unified call notation fallback, mirroring interp.call_function
            # (is_def_var never reaches here: the compiler bails on it)
            if args and not isinstance(args[0], I.np.ndarray):
                try:
                    return interp._method(args[0], name, list(args[1:]))
                except I.RhaiRuntimeError as me:
                    if not str(me).startswith(
                            ("unknown method", "unknown property")):
                        raise
            sig = ", ".join(I._type_of(a) for a in args)
            raise I.RhaiRuntimeError(f"function not found: {name} ({sig})")
        try:
            return hf(*args)
        except TypeError as e:
            # mirror interp.call_function: arity errors are catchable
            # script errors; TypeErrors from INSIDE the fn propagate
            import inspect

            try:
                inspect.signature(hf).bind(*args)
            except TypeError:
                sig = ", ".join(I._type_of(a) for a in args)
                raise I.RhaiRuntimeError(f"function not found: {name} ({sig})")
            raise e

    def _fnptr_call(p, args):
        return _cn(p.name, list(p.curried) + list(args))

    def _cv(val, args, name):
        if isinstance(val, I.Closure):
            return interp.call_closure(val, args)
        if isinstance(val, I.FnPtr):
            return _fnptr_call(val, args)
        return _cn(name, args)

    def _mc(obj, name, args):
        if isinstance(obj, I.FnPtr):
            if args is None:
                if name == "name":
                    return obj.name
                if name == "is_anonymous":
                    return False
                raise I.RhaiRuntimeError(f"unknown property '{name}' on Fn")
            if name == "call":
                return _fnptr_call(obj, args)
            if name == "curry":
                return I.FnPtr(obj.name, list(obj.curried) + list(args))
        return interp._method(obj, name, args)

    def _cvg(val, name, args):
        if val is _UNBOUND:
            return _cn(name, args)
        return _cv(val, args, name)

    def _copy_fast(v):
        return v if type(v) in _SCALAR_TYPES else I._rhai_copy(v)

    env = _make_fast_binops(B)
    env.update({
        "_rt": rt,
        "_B": B,
        "_D": I.to_display,
        "_T": I._truthy,
        "_copy": _copy_fast,
        "_nf": _nf,
        "_uerr": _uerr,
        "_forit": _forit,
        "_ix": _ix,
        "_ai": _ai,
        "_ap": _ap,
        "_swm": _swm, "_Bneg": _Bneg,
        "_cn": _cn,
        "_cv": _cv,
        "_cvg": _cvg,
        "_UNB": _UNBOUND,
        "_mc": _mc,
        "_si": I._string_inplace,
        "_sir": I._string_inplace_ret,
        "_ssi": (lambda s, i, op, v: I._string_index_set(s, i, op, v, B)),
        "_cerr": _cerr,
        "UNIT": I.UNIT,
        "RhaiRange": I.RhaiRange,
        "RhaiRuntimeError": I.RhaiRuntimeError,
        "RhaiSystemError": I.RhaiSystemError,
        "_Throw": I._Throw,
        "_Break": I._Break,
        "_Continue": I._Continue,
        "_Return": I._Return,
        "_MAXDEPTH": I.MAX_CALL_DEPTH,
        "_void": None,
    })
    return env


_SCALAR_TYPES = (int, float, str, bool)


# ---------------------------------------------------------------------------
# Closure-body compilation (the impure per-pixel scalar loop's fast path)
# ---------------------------------------------------------------------------


def _compile_closure(closure) -> object:
    """Compile a Closure's body to a code object of
    `def _cl(_ip, _CH, _args)`.  Captured names pre-resolve to direct
    subscripts of the chain dicts (reads AND writes persist to the
    enclosing environment exactly like the tree-walker); names absent at
    compile time fall back to a dynamic chain walk.  Raises
    TranspileUnsupported for nested closures / fn defs."""
    c = _Compiler(closure_mode=True)
    chain = closure.scope_chain
    # chain dicts become pseudo-scopes whose "pynames" are subscripts
    c.scopes = []
    for i, scope in enumerate(chain):
        c.scopes.append({n: f"_sc{i}[{n!r}]" for n in scope})
    c.toplevel = {}  # sentinel: never matched, so let always mangles
    params_scope = {}
    c.scopes.append(params_scope)
    c.fn_depth = 1
    c.fn_base = 0
    ppys = []
    for p in closure.params:
        params_scope[p] = c.mangle(p)
        ppys.append(params_scope[p])

    c.emit("_tick = _ip.tick")
    for i in range(len(chain)):
        c.emit(f"_sc{i} = _CH[{i}]")
    for j, p in enumerate(ppys):
        c.emit(f"{p} = _copy(_args[{j}])")
    rv = c.tmp()
    c.block_value(closure.body, rv)
    c.emit(f"return {rv}")
    src = "def _cl(_ip, _CH, _args):\n" + "\n".join(c.lines)
    return compile(src, "<rhai-closure>", "exec")


def get_closure_fn(closure, interp):
    """Cached compiled runner for a Closure, or None.  The cache is keyed
    on the chain dicts' length signature: a captured scope gaining a name
    (the growing globals dict) invalidates pre-resolved subscripts, so the
    body recompiles against the new contents."""
    if os.environ.get("PAINTFE_SCRIPT_COMPILE", "auto") == "0":
        return None
    cached = getattr(closure, "_pyc", None)
    if cached == "unsupported":
        return None
    sig = tuple(len(s) for s in closure.scope_chain)
    if cached is not None and cached[0] == sig:
        return cached[1]
    try:
        code = _compile_closure(closure)
    except Exception:
        closure._pyc = "unsupported"
        return None
    env = _closure_env(closure, interp)
    exec(code, env)
    cl = env["_cl"]
    chain_tuple = list(closure.scope_chain)

    def runner(ip, args):
        return cl(ip, chain_tuple, args)

    closure._pyc = (sig, runner)
    return runner


def _closure_env(closure, interp) -> dict:
    """exec-globals for a compiled closure body: operator fast paths plus
    chain-bound resolution helpers (full interp fidelity for dynamic
    names, calls, and methods)."""
    chain = list(closure.scope_chain)
    B = interp._binop

    def _dyn(name):
        for scope in reversed(chain):
            if name in scope:
                return scope[name]
        raise I.RhaiRuntimeError(f"variable '{name}' not found")

    def _dynset(name, op, value):
        for scope in reversed(chain):
            if name in scope:
                if (I._CONST_MARK + name) in scope:
                    raise I.RhaiRuntimeError(
                        f"cannot assign to constant '{name}'")
                if op != "=":
                    value = B(op[:-1], scope[name], value)
                scope[name] = value
                return
        raise I.RhaiRuntimeError(f"variable '{name}' not found")

    def _cn(name, args):
        # full interp resolution against the captured chain (scope vars
        # holding closures/FnPtrs, Fn, type_of, user fns, host fns)
        return interp.call_function(name, args, chain)

    def _cv(val, args, name):
        if isinstance(val, I.Closure):
            return interp.call_closure(val, args)
        if isinstance(val, I.FnPtr):
            return interp.call_function(val.name, list(val.curried) + list(args),
                                        chain)
        # non-callable local shadows the name: continue past the scope
        # walk exactly like interp.call_function's `break` path
        return interp.call_function(name, args, [])

    def _mc(obj, name, args):
        return interp._method(obj, name, args, chain)

    env = _make_fast_binops(B)
    env.update({
        "_B": B,
        "_D": I.to_display,
        "_T": I._truthy,
        "_swm": _swm,
        "_Bneg": _Bneg,
        "_copy": lambda v: v if type(v) in _SCALAR_TYPES else I._rhai_copy(v),
        "_dyn": _dyn,
        "_dynset": _dynset,
        "_cn": _cn,
        "_cv": _cv,
        "_mc": _mc,
        "_si": I._string_inplace,
        "_sir": I._string_inplace_ret,
        "_ssi": (lambda s, i, op, v: I._string_index_set(s, i, op, v, B)),
        "_cerr": _cerr,
        "_uerr": _uerr,
        "UNIT": I.UNIT,
        "RhaiRange": I.RhaiRange,
        "RhaiRuntimeError": I.RhaiRuntimeError,
        "RhaiSystemError": I.RhaiSystemError,
        "_Throw": I._Throw,
        "_Break": I._Break,
        "_Continue": I._Continue,
        "_Return": I._Return,
        "_void": None,
    })

    def _ix(obj, idx):
        try:
            return obj[idx]
        except (IndexError, TypeError, KeyError) as exc:
            raise I.RhaiRuntimeError(f"index error: {exc}")

    def _ai(obj, idx, op, value):
        if isinstance(obj, dict):
            if op != "=":
                value = B(op[:-1], obj.get(idx, I.UNIT), value)
            obj[idx] = value
            return
        if not isinstance(obj, list):
            raise I.RhaiRuntimeError("indexed assignment needs an array or map")
        if op != "=":
            value = B(op[:-1], obj[idx], value)
        obj[idx] = value

    def _ap(obj, key, op, value):
        if isinstance(obj, dict):
            if op != "=":
                value = B(op[:-1], obj.get(key, I.UNIT), value)
            obj[key] = value
            return
        raise I.RhaiRuntimeError("property assignment needs a map")

    def _forit(v):
        if isinstance(v, (I.RhaiRange, I.StepRange)):
            return v
        if isinstance(v, list):
            # Rhai for-in yields cloned values over a snapshot (matches
            # the tree-walker's loop binding)
            return [I._rhai_copy(x) for x in v]
        if isinstance(v, str):
            return list(v)  # Rhai iterates strings by char
        raise I.RhaiRuntimeError("for loop needs a range or array")

    env["_ix"] = _ix
    env["_ai"] = _ai
    env["_ap"] = _ap
    env["_forit"] = _forit
    return env


def _compile_closure_region(closure, with_xy: bool) -> object:
    """Region-runner variant of _compile_closure for the pixel-state-free
    scalar loop (api.py): the per-pixel iteration itself lives in the
    generated code — one direct Python call per pixel (`_px`, whose body
    is the compiled closure) instead of the call_closure dispatch chain,
    with result clamping and row storeback inline.  Only legal when the
    body provably never reads/writes ctx.pixels (closure_avoids_
    pixel_state), which also guarantees the row snapshot semantics."""
    c = _Compiler(closure_mode=True)
    chain = closure.scope_chain
    c.scopes = [{n: f"_sc{i}[{n!r}]" for n in scope}
                for i, scope in enumerate(chain)]
    c.toplevel = {}
    params_scope = {}
    c.scopes.append(params_scope)
    c.fn_depth = 1
    c.fn_base = 0
    ppys = []
    for p in closure.params:
        params_scope[p] = c.mangle(p)
        ppys.append(params_scope[p])

    for i in range(len(chain)):
        c.emit(f"_sc{i} = _CH[{i}]")
    c.emit(f"def _px({', '.join(ppys)}):")
    c.indent += 1
    rv = c.tmp()
    c.block_value(closure.body, rv)
    c.emit(f"return {rv}")
    c.indent -= 1
    c.emit("_tick = _ip.tick")
    c.emit("for _yi in range(len(_rows)):")
    c.emit("    _row = _rows[_yi]")
    c.emit("    _y = _y0 + _yi")
    c.emit("    for _xi in range(len(_row)):")
    c.emit("        _tick()")
    c.emit("        _p = _row[_xi]")
    if with_xy:
        c.emit("        _res = _px(_x0 + _xi, _y, _p[0], _p[1], _p[2], _p[3])")
    else:
        c.emit("        _res = _px(_p[0], _p[1], _p[2], _p[3])")
    c.emit("        if type(_res) is list and len(_res) >= 4:")
    c.emit("            _row[_xi] = [_c8(_res[0], _p[0]), _c8(_res[1], _p[1]), "
           "_c8(_res[2], _p[2]), _c8(_res[3], _p[3])]")
    src = "def _rl(_ip, _CH, _rows, _x0, _y0):\n" + "\n".join(c.lines)
    return compile(src, "<rhai-closure-region>", "exec")


def get_closure_region_fn(closure, interp, with_xy: bool):
    """Cached region runner for a pixel-state-free closure, or None.
    Same chain-length invalidation as get_closure_fn."""
    if os.environ.get("PAINTFE_SCRIPT_COMPILE", "auto") == "0":
        return None
    nparams = 6 if with_xy else 4
    if len(closure.params) != nparams:
        return None
    cached = getattr(closure, "_pyc_region", None)
    if cached == "unsupported":
        return None
    sig = tuple(len(s) for s in closure.scope_chain)
    if cached is not None and cached[0] == sig:
        return cached[1]
    try:
        code = _compile_closure_region(closure, with_xy)
    except Exception:
        closure._pyc_region = "unsupported"
        return None
    env = _closure_env(closure, interp)

    import numpy as _np

    def _c8(v, old):
        # Rhai as_int().unwrap_or(old): only INTs commit (clamped); floats
        # (even integral), bools, anything else keep the old channel value
        if type(v) is int:  # bool has type bool, falls through
            return 0 if v < 0 else (255 if v > 255 else v)
        if isinstance(v, _np.integer) and not isinstance(v, bool):
            vi = int(v)
            return 0 if vi < 0 else (255 if vi > 255 else vi)
        return old

    env["_c8"] = _c8
    exec(code, env)
    rl = env["_rl"]
    chain = list(closure.scope_chain)

    def runner(ip, rows, x0, y0):
        return rl(ip, chain, rows, x0, y0)

    closure._pyc_region = (sig, runner)
    return runner


@functools.lru_cache(maxsize=64)
def _compile_source(source: str):
    """source -> code object of `def _main(_rt)` (or raises)."""
    ast = parse(source)
    c = _Compiler()
    body = c.compile_program(ast)
    src = "def _main(_rt):\n" + body
    return compile(src, "<rhai-transpiled>", "exec")


def try_compile(source: str):
    """Return runner(interp) for the fast path, or None when the script
    needs the tree-walker.  PAINTFE_SCRIPT_COMPILE=0 disables the fast
    path entirely; =1 makes unsupported constructs an error (tests)."""
    mode = os.environ.get("PAINTFE_SCRIPT_COMPILE", "auto")
    if mode == "0":
        return None
    try:
        code = _compile_source(source)
    except TranspileUnsupported:
        if mode == "1":
            raise
        return None
    except Exception as e:
        # the parser's RhaiSyntaxError propagates (same error both paths).
        # Everything else — generated-code SyntaxError corners (break
        # outside a loop, >100 nesting levels) or a genuine compiler bug —
        # must never kill a script the oracle can run: fall back.
        from paintfe_tpu_torch.scripting.rhai_ast import RhaiSyntaxError

        if mode == "1" or isinstance(e, RhaiSyntaxError):
            raise
        return None

    def runner(interp: I.Interpreter):
        rt = _Runtime(interp)
        env = _make_env(rt)
        exec(code, env)
        env["_main"](rt)

    return runner
