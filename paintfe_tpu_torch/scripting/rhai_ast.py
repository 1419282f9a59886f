"""Lexer + parser for the Rhai-compatible scripting language.

The reference embeds Rhai 1.25 (src/ops/scripting.rs); this implements the
language subset its effect scripts use: let/const, fn, closures, if/else
(as expressions), while/loop/for-in with ranges, arrays, template strings
with `${}` interpolation, throw/try-catch, bitwise + shift operators with
Rust precedence, function pointers (Fn/curry), and method-call sugar.
Constructs Rhai supports but this engine deliberately omits (modules,
`this`) raise targeted "unsupported Rhai feature" diagnostics with
line/column, per the reference's error-message contract
(scripting.rs:88-216).  `eval` IS supported (current-scope execution,
tree-walker tier; see interp.call_function).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple


class RhaiSyntaxError(Exception):
    def __init__(self, message, line=None, column=None):
        super().__init__(message)
        self.message = message
        self.line = line
        self.column = column


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------

KEYWORDS = {
    "let", "const", "fn", "if", "else", "while", "loop", "for", "in",
    "break", "continue", "return", "true", "false", "switch", "do", "until",
    "throw", "try", "catch",
}

# Rhai 1.25 keywords this engine deliberately does not implement: raise a
# TARGETED diagnostic instead of a generic parse/lookup error
# (scripting.rs:88-216's error-message contract).
_UNSUPPORTED_KEYWORDS = {
    "import": "module imports are not available in PaintFE scripts",
    "export": "module exports are not available in PaintFE scripts",
    "global": "the 'global' module namespace is not available",
    "private": "private functions are not available",
    "this": "method-style 'this' functions are not available; "
            "use plain functions with explicit arguments",
}

# Reserved in Rhai 1.25 (not legal identifiers there either); rejecting
# them up front matches the reference engine's behavior.
_RESERVED_WORDS = {
    "var", "static", "shared", "goto", "exit", "match", "case", "public",
    "protected", "new", "use", "with", "module", "package", "super", "spawn",
    "thread", "go", "sync", "async", "await", "yield", "default", "void",
    "null", "nil", "is",
}

_PUNCT = [
    "#{",
    "..=", "<<=", ">>=", "**=",
    "==", "!=", "<=", ">=", "&&", "||", "+=", "-=", "*=", "/=", "%=",
    "&=", "|=", "^=", "..",
    "=>", "**", "<<", ">>",
    "+", "-", "*", "/", "%", "=", "<", ">", "!", "(", ")", "{", "}", "[", "]",
    ",", ";", ":", ".", "|", "&", "^",
]


@dataclasses.dataclass
class Tok:
    kind: str  # 'int' 'float' 'str' 'tstr' 'ident' 'kw' 'punct' 'eof'
    value: Any
    line: int
    col: int


def tokenize(src: str) -> List[Tok]:
    toks: List[Tok] = []
    i = 0
    line = 1
    col = 1
    n = len(src)

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        if c in " \t\r\n":
            advance(1)
            continue
        if src.startswith("//", i):
            while i < n and src[i] != "\n":
                advance(1)
            continue
        if src.startswith("/*", i):
            advance(2)
            while i < n and not src.startswith("*/", i):
                advance(1)
            advance(2)
            continue
        start_line, start_col = line, col
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            isfloat = False
            while j < n and (src[j].isdigit() or src[j] == "_"):
                j += 1
            if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
                isfloat = True
                j += 1
                while j < n and (src[j].isdigit() or src[j] == "_"):
                    j += 1
            if j < n and src[j] in "eE":
                k = j + 1
                if k < n and src[k] in "+-":
                    k += 1
                if k < n and src[k].isdigit():
                    isfloat = True
                    j = k
                    while j < n and src[j].isdigit():
                        j += 1
            text = src[i:j].replace("_", "")
            if not isfloat and int(text) > (1 << 63) - 1:
                # Rhai lexes numbers via i64::from_str and FALLS BACK to
                # f64 on overflow: a past-i64::MAX literal is a FLOAT,
                # never a silent Python bigint
                isfloat = True
            toks.append(
                Tok("float" if isfloat else "int",
                    float(text) if isfloat else int(text), start_line, start_col)
            )
            advance(j - i)
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word in _UNSUPPORTED_KEYWORDS:
                raise RhaiSyntaxError(
                    f"unsupported Rhai feature '{word}': "
                    f"{_UNSUPPORTED_KEYWORDS[word]}",
                    start_line, start_col)
            if word in _RESERVED_WORDS:
                raise RhaiSyntaxError(
                    f"'{word}' is a reserved keyword and cannot be used as "
                    "an identifier", start_line, start_col)
            toks.append(Tok("kw" if word in KEYWORDS else "ident", word, start_line, start_col))
            advance(j - i)
            continue
        if c == '"':
            advance(1)
            buf = []
            while i < n and src[i] != '"':
                if src[i] == "\\" and i + 1 < n:
                    esc = src[i + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}.get(esc, esc))
                    advance(2)
                else:
                    buf.append(src[i])
                    advance(1)
            if i >= n:
                raise RhaiSyntaxError("unterminated string", start_line, start_col)
            advance(1)
            toks.append(Tok("str", "".join(buf), start_line, start_col))
            continue
        if c == "'":
            # Rhai char literal.  This engine models chars as 1-char
            # strings (interp.py module notes): `for ch in "abc"` and
            # `ch == 'a'` behave naturally; the divergence is type_of
            # ("string" here vs Rhai's "char") and cross-type == corners.
            advance(1)
            if i < n and src[i] == "\\" and i + 1 < n:
                esc = src[i + 1]
                value = {"n": "\n", "t": "\t", "r": "\r", "'": "'",
                         "\\": "\\", "0": "\0"}.get(esc, esc)
                advance(2)
            elif i < n and src[i] != "'":
                value = src[i]
                advance(1)
            else:
                raise RhaiSyntaxError("empty char literal", start_line,
                                      start_col)
            if i >= n or src[i] != "'":
                raise RhaiSyntaxError("unterminated char literal",
                                      start_line, start_col)
            advance(1)
            toks.append(Tok("str", value, start_line, start_col))
            continue
        if c == "`":
            # template string -> list of ('lit', str) | ('expr', token-substring)
            advance(1)
            parts: List[Tuple[str, Any]] = []
            buf = []
            while i < n and src[i] != "`":
                if src.startswith("${", i):
                    if buf:
                        parts.append(("lit", "".join(buf)))
                        buf = []
                    advance(2)
                    depth = 1
                    expr_start = i
                    while i < n and depth > 0:
                        if src[i] == "{":
                            depth += 1
                        elif src[i] == "}":
                            depth -= 1
                            if depth == 0:
                                break
                        advance(1)
                    parts.append(("expr", src[expr_start:i]))
                    advance(1)  # closing }
                else:
                    buf.append(src[i])
                    advance(1)
            if i >= n:
                raise RhaiSyntaxError("unterminated template string", start_line, start_col)
            advance(1)
            if buf:
                parts.append(("lit", "".join(buf)))
            toks.append(Tok("tstr", parts, start_line, start_col))
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Tok("punct", p, start_line, start_col))
                advance(len(p))
                break
        else:
            raise RhaiSyntaxError(f"unexpected character {c!r}", line, col)
    toks.append(Tok("eof", None, line, col))
    return toks


# ---------------------------------------------------------------------------
# AST nodes (plain tuples: (kind, ...), with line info on statements)
# ---------------------------------------------------------------------------
# Expressions:
#   ('int', v) ('float', v) ('str', v) ('bool', v) ('unit',)
#   ('tstr', [(kind, part-ast)])
#   ('var', name) ('array', [items]) ('index', obj, idx)
#   ('bin', op, l, r) ('un', op, e) ('and', l, r) ('or', l, r)
#   ('call', name, [args]) ('method', obj, name, [args])
#   ('closure', [params], body_block)
#   ('if', cond, then_block, else_block|None)  -- usable as expr
#   ('range', lo, hi, inclusive)
# Statements: ('let', name, expr) ('const', name, expr)
#   ('assign', target, op, expr) ('expr', expr, has_semi)
#   ('while', cond, block) ('loop', block) ('for', var, iterable, block)
#   ('break',) ('continue',) ('return', expr|None) ('fn', name, params, block)
#   ('throw', expr|None) ('try', body_block, catch_var|None, catch_block)
# Block: ('block', [stmts])


class Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.pos = 0

    def peek(self) -> Tok:
        return self.toks[self.pos]

    def next(self) -> Tok:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, kind, value=None) -> Tok:
        t = self.peek()
        if t.kind != kind or (value is not None and t.value != value):
            raise RhaiSyntaxError(
                f"expected {value or kind}, found {t.value!r}", t.line, t.col
            )
        return self.next()

    def at_punct(self, p) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.value == p

    def at_kw(self, k) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value == k

    # -- entry ---------------------------------------------------------------

    def parse_program(self):
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_stmt())
        return ("block", stmts)

    # -- statements ----------------------------------------------------------

    def parse_block(self):
        self.expect("punct", "{")
        stmts = []
        while not self.at_punct("}"):
            if self.peek().kind == "eof":
                t = self.peek()
                raise RhaiSyntaxError("unterminated block", t.line, t.col)
            stmts.append(self.parse_stmt())
        self.expect("punct", "}")
        return ("block", stmts)

    def parse_stmt(self):
        t = self.peek()
        if t.kind == "kw":
            if t.value in ("let", "const"):
                self.next()
                name = self.expect("ident").value
                if self.at_punct("="):
                    self.next()
                    expr = self.parse_expr()
                else:
                    expr = ("unit",)
                if self.at_punct(";"):
                    self.next()
                return ("let" if t.value == "let" else "const", name, expr)
            if t.value == "fn":
                self.next()
                name = self.expect("ident").value
                params = self.parse_params()
                body = self.parse_block()
                return ("fn", name, params, body)
            if t.value == "while":
                self.next()
                cond = self.parse_expr()
                body = self.parse_block()
                return ("while", cond, body)
            if t.value == "do":
                self.next()
                body = self.parse_block()
                kw = self.peek()
                if kw.kind != "kw" or kw.value not in ("while", "until"):
                    raise RhaiSyntaxError(
                        "expected 'while' or 'until' after do block", kw.line, kw.col
                    )
                self.next()
                cond = self.parse_expr()
                if self.at_punct(";"):
                    self.next()
                return ("dowhile", cond, body, kw.value == "until")
            if t.value == "loop":
                self.next()
                body = self.parse_block()
                return ("loop", body)
            if t.value == "for":
                self.next()
                if self.at_punct("("):
                    # Rhai two-binding form: `for (item, counter) in it`
                    # (the reference's Rhai 1.25 BasicIteratorPackage) —
                    # first name binds the value, second the 0-based
                    # iteration counter
                    self.next()
                    var = self.expect("ident").value
                    self.expect("punct", ",")
                    counter = self.expect("ident").value
                    close = self.expect("punct", ")")
                    if counter == var:
                        raise RhaiSyntaxError(
                            f"duplicate variable name '{var}' in for loop",
                            close.line, close.col)
                    var = (var, counter)
                else:
                    var = self.expect("ident").value
                self.expect("kw", "in")
                iterable = self.parse_expr()
                body = self.parse_block()
                return ("for", var, iterable, body)
            if t.value == "break":
                self.next()
                if (self.at_punct(";") or self.at_punct("}")
                        or self.peek().kind == "eof"):
                    expr = None
                else:
                    # `break value` makes the value the enclosing loop
                    # expression's result (Rhai loop expressions)
                    expr = self.parse_expr()
                if self.at_punct(";"):
                    self.next()
                return ("break", expr)
            if t.value == "continue":
                self.next()
                if self.at_punct(";"):
                    self.next()
                return ("continue",)
            if t.value == "return":
                self.next()
                if self.at_punct(";") or self.at_punct("}"):
                    expr = None
                else:
                    expr = self.parse_expr()
                if self.at_punct(";"):
                    self.next()
                return ("return", expr)
            if t.value == "throw":
                self.next()
                if self.at_punct(";") or self.at_punct("}") or self.peek().kind == "eof":
                    expr = None
                else:
                    expr = self.parse_expr()
                if self.at_punct(";"):
                    self.next()
                return ("throw", expr)
            if t.value == "try":
                self.next()
                body = self.parse_block()
                kw = self.peek()
                if kw.kind != "kw" or kw.value != "catch":
                    raise RhaiSyntaxError(
                        "expected 'catch' after try block", kw.line, kw.col)
                self.next()
                var = None
                if self.at_punct("("):
                    self.next()
                    var = self.expect("ident").value
                    self.expect("punct", ")")
                catch_block = self.parse_block()
                return ("try", body, var, catch_block)
        # Block-like constructs at statement position are complete
        # statements (Rhai 1.25 rules): `if c { … } [r,g,b,a]` is an
        # if-STATEMENT followed by a new array-expression statement, not
        # an index into the if's value.  Postfix/binary continuation only
        # applies in expression position (e.g. `let x = if c {1} else {2}`).
        if (t.kind == "kw" and t.value in ("if", "switch")) or self.at_punct("{"):
            expr = self.parse_primary()
            has_semi = False
            if self.at_punct(";"):
                self.next()
                has_semi = True
            return ("expr", expr, has_semi)
        # expression statement (possibly assignment)
        expr = self.parse_expr()
        if self.peek().kind == "punct" and self.peek().value in (
            "=", "+=", "-=", "*=", "/=", "%=",
            "**=", "<<=", ">>=", "&=", "|=", "^=",
        ):
            op = self.next().value
            rhs = self.parse_expr()
            if self.at_punct(";"):
                self.next()
            return ("assign", expr, op, rhs)
        has_semi = False
        if self.at_punct(";"):
            self.next()
            has_semi = True
        return ("expr", expr, has_semi)

    def parse_params(self):
        self.expect("punct", "(")
        params = []
        while not self.at_punct(")"):
            params.append(self.expect("ident").value)
            if self.at_punct(","):
                self.next()
        self.expect("punct", ")")
        return params

    # -- expressions (precedence climbing) ------------------------------------

    def parse_expr(self):
        return self.parse_range()

    def parse_switch_pattern(self):
        """A switch-arm pattern: like an expression, but `|` separates
        alternative patterns instead of acting as bitwise-or."""
        lo = self.parse_bitxor()
        if self.at_punct("..") or self.at_punct("..="):
            inclusive = self.next().value == "..="
            hi = self.parse_bitxor()
            return ("range", lo, hi, inclusive)
        return lo

    def parse_range(self):
        lo = self.parse_or()
        if self.at_punct("..") or self.at_punct("..="):
            inclusive = self.next().value == "..="
            hi = self.parse_or()
            return ("range", lo, hi, inclusive)
        return lo

    def parse_or(self):
        l = self.parse_and()
        while self.at_punct("||"):
            self.next()
            r = self.parse_and()
            l = ("or", l, r)
        return l

    def parse_and(self):
        l = self.parse_cmp()
        while self.at_punct("&&"):
            self.next()
            r = self.parse_cmp()
            l = ("and", l, r)
        return l

    def parse_cmp(self):
        l = self.parse_bitor()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("==", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                r = self.parse_bitor()
                l = ("bin", op, l, r)
            elif t.kind == "kw" and t.value == "in":
                self.next()
                r = self.parse_bitor()
                if self.at_punct("..") or self.at_punct("..="):
                    inclusive = self.next().value == "..="
                    r = ("range", r, self.parse_bitor(), inclusive)
                l = ("bin", "in", l, r)
            else:
                break
        return l

    # Bitwise levels follow Rust/Rhai precedence: comparisons are LOOSER
    # than | ^ &, which are looser than shifts (so `3 | 4 == 7` is
    # `(3 | 4) == 7` and `1 << 2 + 1` is `1 << 3`).
    def parse_bitor(self):
        l = self.parse_bitxor()
        while self.at_punct("|"):
            self.next()
            r = self.parse_bitxor()
            l = ("bin", "|", l, r)
        return l

    def parse_bitxor(self):
        l = self.parse_bitand()
        while self.at_punct("^"):
            self.next()
            r = self.parse_bitand()
            l = ("bin", "^", l, r)
        return l

    def parse_bitand(self):
        l = self.parse_shift()
        while self.at_punct("&"):
            self.next()
            r = self.parse_shift()
            l = ("bin", "&", l, r)
        return l

    def parse_shift(self):
        l = self.parse_add()
        while self.peek().kind == "punct" and self.peek().value in ("<<", ">>"):
            op = self.next().value
            r = self.parse_add()
            l = ("bin", op, l, r)
        return l

    def parse_add(self):
        l = self.parse_mul()
        while self.peek().kind == "punct" and self.peek().value in ("+", "-"):
            op = self.next().value
            r = self.parse_mul()
            l = ("bin", op, l, r)
        return l

    def parse_mul(self):
        l = self.parse_unary()
        while self.peek().kind == "punct" and self.peek().value in ("*", "/", "%", "**"):
            op = self.next().value
            r = self.parse_unary()
            l = ("bin", op, l, r)
        return l

    def parse_unary(self):
        if self.at_punct("-"):
            self.next()
            return ("un", "-", self.parse_unary())
        if self.at_punct("!"):
            self.next()
            return ("un", "!", self.parse_unary())
        if self.at_punct("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.at_punct("."):
                self.next()
                name = self.expect("ident").value
                if self.at_punct("("):
                    args = self.parse_args()
                    e = ("method", e, name, args)
                else:
                    e = ("method", e, name, None)  # property access
            elif self.at_punct("["):
                self.next()
                idx = self.parse_expr()
                self.expect("punct", "]")
                e = ("index", e, idx)
            else:
                break
        return e

    def parse_args(self):
        self.expect("punct", "(")
        args = []
        while not self.at_punct(")"):
            args.append(self.parse_expr())
            if self.at_punct(","):
                self.next()
        self.expect("punct", ")")
        return args

    def parse_primary(self):
        t = self.peek()
        if t.kind == "kw" and t.value in ("loop", "while", "do", "for"):
            # Rhai loop EXPRESSIONS: `let x = loop { ...; break v; };`
            # evaluates to the break value (or () on normal exit)
            return ("stmtexpr", self.parse_stmt())
        if t.kind == "int":
            self.next()
            return ("int", t.value)
        if t.kind == "float":
            self.next()
            return ("float", t.value)
        if t.kind == "str":
            self.next()
            return ("str", t.value)
        if t.kind == "tstr":
            self.next()
            parts = []
            for kind, payload in t.value:
                if kind == "lit":
                    parts.append(("lit", payload))
                else:
                    sub = Parser(tokenize(payload))
                    parts.append(("expr", sub.parse_expr()))
            return ("tstr", parts)
        if t.kind == "kw" and t.value in ("true", "false"):
            self.next()
            return ("bool", t.value == "true")
        if t.kind == "kw" and t.value == "switch":
            self.next()
            subject = self.parse_expr()
            self.expect("punct", "{")
            arms = []
            default = None
            while not self.at_punct("}"):
                if self.peek().kind == "ident" and self.peek().value == "_":
                    self.next()
                    if self.at_kw("if"):
                        # guarded default: an always-matching arm whose
                        # guard decides (later arms still get a chance)
                        self.next()
                        guard = self.parse_expr()
                        self.expect("punct", "=>")
                        body = (self.parse_block() if self.at_punct("{")
                                else self.parse_expr())
                        arms.append((None, guard, body))
                    else:
                        self.expect("punct", "=>")
                        body = (self.parse_block() if self.at_punct("{")
                                else self.parse_expr())
                        default = body
                else:
                    # patterns parse BELOW the bitor level so `1 | 2 =>`
                    # stays two alternatives, not a bitwise-or expression
                    pats = [self.parse_switch_pattern()]
                    while self.at_punct("|"):
                        self.next()
                        pats.append(self.parse_switch_pattern())
                    guard = None
                    if self.at_kw("if"):
                        # Rhai case condition: `pattern if guard =>`
                        self.next()
                        guard = self.parse_expr()
                    self.expect("punct", "=>")
                    body = (self.parse_block() if self.at_punct("{")
                            else self.parse_expr())
                    arms.append((pats, guard, body))
                if self.at_punct(","):
                    self.next()
            self.expect("punct", "}")
            return ("switch", subject, arms, default)
        if t.kind == "kw" and t.value == "if":
            self.next()
            cond = self.parse_expr()
            then = self.parse_block()
            els = None
            if self.at_kw("else"):
                self.next()
                if self.at_kw("if"):
                    els = ("block", [("expr", self.parse_primary(), False)])
                else:
                    els = self.parse_block()
            return ("if", cond, then, els)
        if t.kind == "ident":
            self.next()
            if self.at_punct("("):
                args = self.parse_args()
                return ("call", t.value, args)
            return ("var", t.value)
        if t.kind == "punct" and t.value == "(":
            self.next()
            if self.at_punct(")"):
                self.next()
                return ("unit",)
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        if t.kind == "punct" and t.value == "#{":
            self.next()
            pairs = []
            while not self.at_punct("}"):
                kt = self.peek()
                if kt.kind in ("ident", "str"):
                    self.next()
                    key = kt.value
                else:
                    raise RhaiSyntaxError("expected map key", kt.line, kt.col)
                self.expect("punct", ":")
                pairs.append((key, self.parse_expr()))
                if self.at_punct(","):
                    self.next()
            self.expect("punct", "}")
            return ("map", pairs)
        if t.kind == "punct" and t.value == "[":
            self.next()
            items = []
            while not self.at_punct("]"):
                items.append(self.parse_expr())
                if self.at_punct(","):
                    self.next()
            self.expect("punct", "]")
            return ("array", items)
        if t.kind == "punct" and t.value == "|":
            self.next()
            params = []
            while not self.at_punct("|"):
                params.append(self.expect("ident").value)
                if self.at_punct(","):
                    self.next()
            self.expect("punct", "|")
            if self.at_punct("{"):
                body = self.parse_block()
            else:
                body = ("block", [("expr", self.parse_expr(), False)])
            return ("closure", params, body)
        if t.kind == "punct" and t.value == "||":
            # zero-arg closure
            self.next()
            if self.at_punct("{"):
                body = self.parse_block()
            else:
                body = ("block", [("expr", self.parse_expr(), False)])
            return ("closure", [], body)
        if t.kind == "punct" and t.value == "{":
            return self.parse_block()
        raise RhaiSyntaxError(f"unexpected token {t.value!r}", t.line, t.col)


def parse(source: str):
    return Parser(tokenize(source)).parse_program()
