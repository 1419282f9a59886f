"""The port's script API (paintfe_tpu_torch.scripting.api) on the cases of
tests/test_scripting.py: every script runs through the JAX package's
engine and the port's (device="cpu") on the same inputs, and the pixels,
dims, console, canvas ops and error messages must agree at tolerance 0.
Each JAX test's own expectation is asserted on the port's result too; a
reference golden is compared only where the golden tree is mounted, as
tests/common.py does, and the case still holds the port to the JAX
package without it.  The vectorizer's fallbacks are held as the JAX tests
hold them: forced-scalar (closure_is_pure patched to False in the port's
api module) against the vectorized run."""

import collections
import queue
import random

import numpy as np
import pytest

import paintfe_tpu.scripting as jscript
import paintfe_tpu_torch.scripting as tscript
from paintfe_tpu.core import fixtures as jfix
from paintfe_tpu.scripting import api as japi
from paintfe_tpu.scripting import engine as jengine
from paintfe_tpu.scripting import interp as jinterp
from paintfe_tpu.scripting import rhai_ast as jast
from paintfe_tpu_torch.core import fixtures as tfix
from paintfe_tpu_torch.ops import adjustments as tadj
from paintfe_tpu_torch.scripting import api as tapi
from paintfe_tpu_torch.scripting import engine as tengine
from paintfe_tpu_torch.scripting import interp as tinterp
from paintfe_tpu_torch.scripting import rhai_ast as tast

from common import assert_golden, golden_path

Run = collections.namedtuple("Run", "error pixels width height console ops")


def run(pkg, source, img, mask=None, rng_seed=None):
    """`source` through `pkg`'s execute_script_sync on a copy of `img`: the
    port on the CPU.  An error is (message, line, column)."""
    h, w = img.shape[:2]
    kw = {"device": "cpu"} if pkg is tscript else {}
    try:
        px, nw, nh, console, ops = pkg.execute_script_sync(
            source, img.copy(), w, h, mask, rng_seed=rng_seed, **kw)
    except pkg.ScriptError as e:
        return Run((e.message, e.line, e.column), None, None, None, None, None)
    return Run(None, np.asarray(px).reshape(nh, nw, 4), nw, nh, list(console),
               [(o.kind, o.w, o.h, o.filter, tuple(o.anchor)) for o in ops])


def assert_same(out, ref):
    assert out.error == ref.error
    assert (out.pixels is None) == (ref.pixels is None)
    if out.pixels is not None:
        np.testing.assert_array_equal(out.pixels, ref.pixels)
    assert (out.width, out.height, out.console, out.ops) == (
        ref.width, ref.height, ref.console, ref.ops)


def gradient(size=64):
    img = tfix.test_gradient(size, size)
    np.testing.assert_array_equal(img, jfix.test_gradient(size, size))
    return img


def both(source, img=None, mask=None, rng_seed=None):
    """The port's run of `source`, after holding it to the JAX package's."""
    img = gradient() if img is None else img
    out = run(tscript, source, img, mask, rng_seed)
    assert_same(out, run(jscript, source, img, mask, rng_seed))
    return out


def ok(source, img=None, rng_seed=None):
    out = both(source, img, rng_seed=rng_seed)
    assert out.error is None, out.error
    return out.pixels, out.console


def seeded(source, size=4, seed=12345):
    return ok(source, gradient(size), rng_seed=seed)


def scalar_only(monkeypatch):
    """Force the port's per-pixel scalar loop (the semantic oracle)."""
    monkeypatch.setattr(tapi, "closure_is_pure", lambda *a, **k: False)


def random_image(size, seed):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 4), dtype=np.uint8)


def both_ways(source, monkeypatch, size=48, seed=7):
    """Vectorized and forced-scalar runs of the port agree with each other
    and with the JAX package's vectorized run; returns the port's run."""
    img = random_image(size, seed)
    vec = both(source, img)
    with monkeypatch.context() as m:
        scalar_only(m)
        assert_same(run(tscript, source, img), vec)
    return vec


# -- pixel access, printing, the golden effects ------------------------------


def test_width_height():
    _, console = ok("let w = width(); let h = height(); print_line(`${w}x${h}`);")
    assert console[-1] == "64x64"


def test_set_pixel():
    px, _ = ok("set_pixel(0, 0, 255, 0, 0, 255); set_pixel(1, 0, 0, 255, 0, 128);")
    np.testing.assert_array_equal(px[0, 0], [255, 0, 0, 255])
    np.testing.assert_array_equal(px[0, 1], [0, 255, 0, 128])


def test_get_pixel_roundtrip():
    px, _ = ok("let r = get_r(0, 0); let g = get_g(0, 0); let b = get_b(0, 0); "
               "let a = get_a(0, 0); set_pixel(1, 1, r, g, b, a);")
    np.testing.assert_array_equal(px[1, 1], gradient()[0, 0])


GOLDEN_SCRIPTS = [
    ("for_each_pixel_invert",
     "for_each_pixel(|x, y, r, g, b, a| { [255 - r, 255 - g, 255 - b, a] });"),
    ("map_channels_invert", "map_channels(|r, g, b, a| { [255 - r, 255 - g, 255 - b, a] });"),
    ("apply_blur", "apply_blur(2.0);"),
    ("apply_invert", "apply_invert();"),
    ("apply_sepia", "apply_sepia();"),
    ("apply_desaturate", "apply_desaturate();"),
    ("apply_brightness_contrast", "apply_brightness_contrast(20.0, 10.0);"),
    ("apply_pixelate", "apply_pixelate(4);"),
    ("flip_horizontal", "flip_horizontal();"),
    ("flip_vertical", "flip_vertical();"),
]


@pytest.mark.parametrize("name,source", GOLDEN_SCRIPTS, ids=[n for n, _ in GOLDEN_SCRIPTS])
def test_golden_script_matches_jax(name, source):
    px, _ = ok(source)
    if golden_path("scripting", name).exists():
        assert_golden("scripting", name, px)


def test_flip_roundtrip():
    px, _ = ok("flip_horizontal();\nflip_horizontal();")
    np.testing.assert_array_equal(px, gradient())


def test_print():
    _, console = ok('print_line("hello world"); print_line("second line");')
    assert any("hello world" in line for line in console)
    assert any("second line" in line for line in console)


def test_clamp():
    _, console = ok("let v = clamp(300, 0, 255); print_line(`${v}`);")
    assert console[-1] == "255"


@pytest.mark.parametrize("source", ["let x = ;", "let x = 1 / 0;"])
def test_script_error_matches_jax(source):
    assert both(source).error is not None


def test_script_invert_matches_native():
    px, _ = ok("apply_invert();")
    native = tadj.invert_colors(gradient(), device="cpu")
    np.testing.assert_array_equal(px, np.asarray(native))


# -- selections ----------------------------------------------------------------


def test_select_rect_limits_effect():
    px, _ = ok("select_rect(10, 10, 30, 30); fill_selected(255, 0, 0, 255);")
    np.testing.assert_array_equal(px[20, 20, :3], [255, 0, 0])
    assert px[5, 5, 0] != 255


def test_select_ellipse():
    px, _ = ok("select_ellipse(32.0, 32.0, 15.0, 15.0); fill_selected(255, 0, 255, 255);")
    np.testing.assert_array_equal(px[32, 32, :3], [255, 0, 255])
    assert px[0, 0, 0] == 0 and px[0, 0, 1] == 255


def test_clear_selection():
    px, _ = ok("select_rect(0, 0, 10, 10); clear_selection(); fill_selected(0, 0, 255, 255);")
    assert px[50, 50, 2] == 255


def test_has_selection():
    _, console = ok('print_line("before: " + has_selection()); select_rect(0, 0, 10, 10); '
                    'print_line("after: " + has_selection()); clear_selection(); '
                    'print_line("cleared: " + has_selection());')
    assert any("before: false" in line for line in console)
    assert any("after: true" in line for line in console)
    assert any("cleared: false" in line for line in console)


def test_invert_selection():
    px, _ = ok("select_rect(10, 10, 54, 54); invert_selection(); fill_selected(255, 0, 255, 255);")
    assert px[0, 0, 0] == 255 and px[0, 0, 2] == 255
    assert not (px[32, 32, 0] == 255 and px[32, 32, 2] == 255)


def test_delete_selected():
    px, _ = ok("select_rect(20, 20, 44, 44); delete_selected();")
    assert px[32, 32, 3] == 0
    assert px[5, 5, 3] > 0


def test_selected_for_each_pixel():
    px, _ = ok("select_rect(0, 0, 32, 64); for_each_pixel(|x, y, r, g, b, a| { "
               "if is_selected(x, y) { [255 - r, 255 - g, 255 - b, a] } else { [r, g, b, a] } });")
    assert px[32, 5, 0] > 200
    assert px[32, 50, 0] > 100


# -- language, canvas ops, rng ---------------------------------------------------


def test_user_function_and_loops():
    _, console = ok("fn double(x) { x * 2 } let total = 0; "
                    "for i in 0..5 { total += double(i); } print_line(`${total}`);")
    assert console[-1] == "20"


def test_canvas_ops_recorded():
    out = both("rotate_canvas_90cw();")
    assert (out.width, out.height) == (64, 64)
    assert [o[0] for o in out.ops] == ["rot90cw"]


def test_resize_image_script():
    out = both('resize_image(32, 32, "bilinear");')
    assert (out.width, out.height) == (32, 32)
    assert out.pixels.shape == (32, 32, 4)
    assert out.ops[0][0] == "resize_image"


def test_rand_deterministic_with_seed():
    src = "print_line(`${rand_int(0, 100)}`);"
    a = both(src, gradient(8), rng_seed=1234)
    b = both(src, gradient(8), rng_seed=1234)
    assert a.console == b.console


def test_switch_expression():
    _, console = ok("""
        let mode = "dark";
        let label = switch mode { "bright" => "B", "dark" | "dim" => "D", _ => "?" };
        print_line(label);
        let n = switch 2 { 1 => 10, 2 => { let q = 20; q + 2 }, _ => 0 };
        print_line(`${n}`);
        let fallthrough = switch 99 { 1 => 10, _ => -1 };
        print_line(`${fallthrough}`);
        """)
    assert console == ["D", "22", "-1"]


def test_object_maps():
    _, console = ok("""
        let m = #{a: 1, "b": 2};
        m.c = m.a + m.b; m.a += 10; m["d"] = 4; m["d"] *= 3;
        print_line(`${m}`);
        print_line(`${m.keys()}`);
        print_line(`${m.len}`);
        print_line(`${m.contains("b")} ${m.remove("b")} ${m.contains("b")}`);
        """)
    assert console == ['#{"a": 11, "b": 2, "c": 3, "d": 12}', '["a", "b", "c", "d"]',
                       "4", "true 2 false"]


def test_in_operator():
    _, console = ok("""
        print_line(`${3 in 0..5} ${5 in 0..5} ${5 in 0..=5}`);
        print_line(`${"right" in "brightness"}`);
        print_line(`${2 in [1, 2, 3]} ${9 in [1, 2, 3]}`);
        print_line(`${"a" in #{a: 1}} ${"z" in #{a: 1}}`);
        """)
    assert console == ["true false true", "true", "true false", "true false"]


def test_do_while_until():
    _, console = ok("""
        let total = 0; let i = 0;
        do { total += i; i += 1; } while i < 5
        print_line(`${total}`);
        let j = 10;
        do { j -= 1; } until j <= 3
        print_line(`${j}`);
        let ran = 0;
        do { ran += 1; } while false
        print_line(`${ran}`);
        """)
    assert console == ["10", "3", "1"]


def test_switch_range_patterns():
    _, console = ok("""
        for v in [3, 15, 120, 255] {
            let label = switch v { 0..10 => "low", 10..=100 => "mid", _ => "high", };
            print_line(label);
        }
        """)
    assert console == ["low", "mid", "high", "high"]


def test_string_method_tail():
    _, console = ok("""
        let s = "  Paint FE  ";
        s.trim();
        print_line(`[${s}]`);
        print_line(`${s.index_of("FE")}`);
        print_line(`${s.sub_string(6, 2)}`);
        print_line(`${s.sub_string(6)}`);
        print_line(`${s.starts_with("Paint")} ${s.ends_with("FE")}`);
        s.replace("FE", "TPU"); print_line(s);
        s.make_upper(); print_line(s);
        s.truncate(5); print_line(s);
        let parts = "a,b,c".split(",");
        print_line(`${parts.len} ${parts[1]}`);
        """)
    assert console == ["[Paint FE]", "6", "FE", "FE", "true true",
                       "Paint TPU", "PAINT TPU", "PAINT", "3 b"]


def test_nested_closures_capture():
    _, console = ok("""
        let make_adder = |n| |x| x + n;
        let add5 = make_adder.call(5);
        print_line(`${add5.call(10)}`);
        let fns = [];
        for i in 0..3 { fns.push(make_adder.call(i * 100)); }
        print_line(`${fns[0].call(1)} ${fns[1].call(1)} ${fns[2].call(1)}`);
        """)
    assert console == ["15", "1 101 201"]


# -- the vectorizer: purity, per-pixel effects, fallbacks --------------------------


def test_rand_in_closure_is_per_pixel():
    px, _ = seeded("for_each_pixel(|x, y, r, g, b, a| [rand_int(0, 200), g, b, a]);", size=8)
    assert len(set(px[..., 0].ravel().tolist())) > 16


def test_rand_in_closure_matches_scalar_semantics():
    seed = 987654321
    px, _ = seeded("for_each_pixel(|x, y, r, g, b, a| [rand_int(0, 200), g, b, a]);",
                   size=4, seed=seed)
    mask64 = (1 << 64) - 1
    s, expect = seed, []
    for _ in range(16):
        s ^= (s << 13) & mask64
        s ^= s >> 7
        s ^= (s << 17) & mask64
        expect.append(s % 200)
    np.testing.assert_array_equal(px[..., 0].ravel(), expect)


def test_closure_console_effects_exact():
    _, console = seeded("for_each_pixel(|x, y, r, g, b, a| { print_line(`${x},${y}`); "
                        "if r > 100 { [255, g, b, a] } else { [0, g, b, a] } });")
    assert len(console) == 16
    assert console[0] == "0,0" and console[-1] == "3,3"


def test_block_statement_then_array_literal_parses():
    px, _ = ok("for_each_pixel(|x, y, r, g, b, a| { let rr = r; "
               "if rr > 100 { rr = 255; } [rr, g, b, a] });")
    img = gradient()
    expect = img.copy()
    expect[..., 0] = np.where(img[..., 0] > 100, 255, img[..., 0])
    np.testing.assert_array_equal(px, expect)


def test_pure_closure_with_branch_matches_numpy():
    px, console = ok("for_each_pixel(|x, y, r, g, b, a| { "
                     "if (x + y) % 2 == 0 { [r, 0, 0, a] } else { [0, g, 0, a] } });")
    assert console == []
    img = gradient()
    yy, xx = np.mgrid[0:64, 0:64]
    even = (xx + yy) % 2 == 0
    expect = np.zeros_like(img)
    expect[..., 0] = np.where(even, img[..., 0], 0)
    expect[..., 1] = np.where(even, 0, img[..., 1])
    expect[..., 3] = img[..., 3]
    np.testing.assert_array_equal(px, expect)


def test_captured_mutation_not_vectorized():
    _, console = ok("let total = 0; for_each_pixel(|x, y, r, g, b, a| { total += 1; }); "
                    "print_line(`${total}`);")
    assert console == [f"{64 * 64}"]


PURITY = [
    ("|x, y, r, g, b, a| [255 - r, g, b, a]", True),
    ("|r, g, b, a| { let l = clamp(r + 10, 0, 255); [l, g, b, a] }", True),
    ("|r, g, b, a| { let v = r; v += 1; [v, g, b, a] }", True),
    ("|r, g, b, a| [rand_int(0, 10), g, b, a]", False),
    ("|r, g, b, a| { print_line(`x`); [r, g, b, a] }", False),
    ("|x, y, r, g, b, a| { set_pixel(x, y, 0, 0, 0, 255); }", False),
    ('|x| { m.set("last", x); x }', False),
    ("|x| { m.mixin(#{ a: x }); x }", False),
    ('|x| { let m = #{}; m.set("k", x); m.get("k") }', True),
]


@pytest.mark.parametrize("source,pure", PURITY, ids=[s for s, _ in PURITY])
def test_purity_scanner_classification(source, pure):
    def purity(ast, interp, api):
        expr = ast.parse(source)[1][0][1]
        assert expr[0] == "closure"
        return api.closure_is_pure(interp.Closure(expr[1], expr[2], []))

    assert purity(tast, tinterp, tapi) == purity(jast, jinterp, japi) == pure


def test_differential_vectorized_vs_scalar_fuzz():
    rng = random.Random(20260816)
    leaves = ["x", "y", "r", "g", "b", "a", "17", "3", "128", "255"]

    def gen_expr(depth):
        if depth == 0:
            return rng.choice(leaves)
        op = rng.choice(["+", "-", "*", "%", "min", "max", "clamp"])
        a, b = gen_expr(depth - 1), gen_expr(depth - 1)
        if op == "min":
            return f"min_i({a}, {b})"
        if op == "max":
            return f"max_i({a}, {b})"
        if op == "clamp":
            return f"clamp({a}, 0, 255)"
        if op == "%":
            return f"(({a}) % 251 + 251) % 251"
        return f"(({a}) {op} ({b}))"

    for trial in range(12):
        chans = [gen_expr(rng.randint(1, 3)) for _ in range(3)]
        body = (f"[clamp({chans[0]},0,255), clamp({chans[1]},0,255), "
                f"clamp({chans[2]},0,255), a]")
        fast, _ = seeded(f"for_each_pixel(|x, y, r, g, b, a| {body});", size=8)
        slow, _ = seeded("for_each_pixel(|x, y, r, g, b, a| {\n  print(\"\");\n"
                         f"  {body}\n}});", size=8)
        np.testing.assert_array_equal(fast, slow, err_msg=f"trial {trial}: {body}")


def test_parser_fuzz_no_crashes():
    """Token soup: both packages give the same ScriptError (or the same
    result), and nothing else escapes."""
    rng = random.Random(42)
    atoms = ["let", "if", "else", "{", "}", "(", ")", "[", "]", "|", "==", "=",
             "+", "-", "*", "/", "fn", "for", "in", "..", ";", ",", "x", "1",
             "2.5", '"s"', "`t${x}`", "while", "return", "=>", "switch", "#{", ":"]
    for _ in range(300):
        src = " ".join(rng.choice(atoms) for _ in range(rng.randint(1, 25)))
        both(src, gradient(4))


def test_impure_call_in_assignment_target_index():
    px, _ = ok("for_each_pixel(|x, y, r, g, b, a| { let v = [0, 0, 0, 0]; "
               "v[rand_int(0, 3)] = 120; [clamp(r + v[0], 0, 255), g, b, a] });",
               rng_seed=12345)  # seeded, so that both packages draw the same stream
    assert len(set(px[..., 0].reshape(-1).tolist())) > 8


def test_let_copies_arrays_value_semantics():
    _, console = ok("let log = []; for_each_pixel(|x, y, r, g, b, a| { let t = log; "
                    "t.push(1); [r, g, b, a] }); print_line(`${log.len()}`);")
    assert console[-1] == "0"


def test_script_fn_args_are_copied():
    _, console = ok("fn stomp(arr) { arr.push(99); arr.len() } let a = [1, 2]; "
                    "let n = stomp(a); print_line(`${n} ${a.len()}`);")
    assert console[-1] == "3 2"


@pytest.mark.parametrize("source,line", [
    ('fn tag() { print_line("hi"); 1 } '
     "for_region(0, 0, 4, 4, |x, y, r, g, b, a| { let q = tag(); [r, g, b, a] });", "hi"),
    ('let abs = |v| { print_line("shadow"); v }; '
     "for_region(0, 0, 4, 4, |x, y, r, g, b, a| { let q = abs(r); [q, g, b, a] });",
     "shadow"),
], ids=["user_fn", "let_bound_closure"])
def test_shadowing_host_name_runs_scalar(source, line):
    _, console = ok(source)
    assert sum(1 for c in console if c == line) == 16


def test_string_inplace_on_indexed_receiver():
    _, console = ok('let a = ["hello"]; a[0].make_upper(); let m = #{ s: "world" }; '
                    'm.s.make_upper(); print_line(a[0] + " " + m.s);')
    assert console[-1] == "HELLO WORLD"


def test_inplace_op_after_device_backed_apply():
    px, _ = ok("apply_blur(1.0);\napply_invert();\nset_pixel(0, 0, 1, 2, 3, 4);")
    np.testing.assert_array_equal(px[0, 0], [1, 2, 3, 4])


VECTORIZED = [
    ("if_else_chain", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let lum = (r * 77 + g * 151 + b * 28) >> 8;
            if lum > 128 { let boost = lum - 128; [r + boost / 2, g, b - boost / 4, a] }
            else if lum > 64 { [r, g + 10, b, a] }
            else { [255 - r, 255 - g, 255 - b, a] }
        });"""),
    ("nested_if", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            if r > 100 { if g > 100 { [255, 255, b, a] } else { [255, 0, b, a] } }
            else { [0, g, b, a] }
        });"""),
    ("branch_writes_local", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let v = r; let w = g;
            if r > g { v = 255; w = w / 2; } else { v += 5; }
            [v, w, b, a]
        });"""),
    ("logical_ops_and_negation", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let hot = r > 200 || g > 200;
            let cold = !(r > 50) && b < 128;
            if hot && !cold { [255, g, b, a] }
            else if cold || b % 3 == 0 { [r, 255, b, a] }
            else { [r, g, 255, a] }
        });"""),
    ("int_division_truncates", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let d = (r - 128) / 3;
            let m = (g - 128) % 5;
            if d < 0 { [0 - d, m + 128, b, a] } else { [d, m + 128, b, a] }
        });"""),
    ("spatial_and_data_mixed", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            if x < 10 || (y > 20 && r > 128) { [255 - r, g, b, a] }
            else { [r, 255 - g, b, a] }
        });"""),
    ("if_statement_falls_through", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let rr = r;
            if rr > 100 { rr = 255; }
            if rr < 30 { rr = 30; }
            [rr, g, b, a]
        });"""),
    ("static_range_loop", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let acc = 0;
            for i in 0..3 { if r > i * 80 { acc += 40; } }
            [acc, g, b, a]
        });"""),
    ("unsupported_merge_falls_back", 16, """
        for_each_pixel(|x, y, r, g, b, a| {
            if r > 128 { [255, 0, 0, 255] } else { [r, g, b] }
        });"""),
    ("shift_in_range", 48, """
        for_each_pixel(|x, y, r, g, b, a| {
            let v = (r / 16) << 3;
            let w = g >> 2;
            if v > w { [v, w, b, a] } else { [w, v, b, a] }
        });"""),
    ("float_channel", 48, "for_each_pixel(|x, y, r, g, b, a| { [r + 0.5, g, b, a] });"),
    ("bool_channel", 48, "for_each_pixel(|x, y, r, g, b, a| { [r > 10, g, b, a] });"),
    ("integral_float_channel", 48,
     "for_each_pixel(|x, y, r, g, b, a| { [(r / 2) * 2.0, g, b, a] });"),
    ("i64_in_range_product", 16,
     "for_each_pixel(|x, y, r, g, b, a| { let big = (r - 128) * 18014398509481984; "
     "let v = if big > 0 { 255 } else { 0 }; [v, g, b, a] });"),
]


@pytest.mark.parametrize("name,size,source", VECTORIZED, ids=[v[0] for v in VECTORIZED])
def test_vectorized_equals_scalar(name, size, source, monkeypatch):
    assert both_ways(source, monkeypatch, size=size).error is None


def test_predicated_path_actually_vectorizes():
    src = ("for_each_pixel(|x, y, r, g, b, a| { "
           "if r > 128 { [255 - r, g, b, a] } else { [r, 255 - g, b, a] } });")

    def ops(api, interp, **kw):
        ctx = api.ScriptContext(gradient(), 64, 64, None, None, **kw)
        ref = {}
        it = interp.Interpreter(api.build_host_fns(ctx, ref))
        ref["interp"] = it
        it.run(src)
        return it.ops, ctx.pixels

    t_ops, t_px = ops(tapi, tinterp, device="cpu")
    j_ops, j_px = ops(japi, jinterp)
    assert t_ops == j_ops
    np.testing.assert_array_equal(t_px, np.asarray(j_px))
    assert t_ops < 2000, f"fell back to scalar loop ({t_ops} ops)"


SCALAR_ERRORS = [
    ("for_each_pixel(|x, y, r, g, b, a| { let v = !r; [g, g, g, a] });", "bool"),
    ("for_each_pixel(|x, y, r, g, b, a| { [!r, g, b, a] });", "bool"),
    ("for_each_pixel(|x, y, r, g, b, a| { let v = 1 << (r / 16 + 60); [v % 256, g, b, a] });",
     "integer overflow"),
    ("for_each_pixel(|x, y, r, g, b, a| { let big = (r + 2) * 144115188075855872; "
     "[if big > 0 { 255 } else { 0 }, g, b, a] });", "integer overflow"),
    ("for_each_pixel(|x, y, r, g, b, a| { let big = (r + 1) ** 9; [b, g, b, a] });",
     "integer overflow"),
]


@pytest.mark.parametrize("source,needle", SCALAR_ERRORS, ids=[s[33:70] for s, _ in SCALAR_ERRORS])
def test_vectorized_error_equals_scalar_error(source, needle, monkeypatch):
    img = random_image(16, 7)
    vec = both(source, img)
    assert vec.error is not None and needle in vec.error[0]
    with monkeypatch.context() as m:
        scalar_only(m)
        assert run(tscript, source, img).error[0] == vec.error[0]


@pytest.mark.parametrize("source,fill,old", [
    ("for_each_pixel(|x, y, r, g, b, a| { [r + 0.5, 9, b, a] });", 77, 77),
    ("for_each_pixel(|x, y, r, g, b, a| { [r > 10, g, b, a] });", 50, 50),
    ("for_each_pixel(|x, y, r, g, b, a| { [(r / 2) * 2.0, g, b, a] });", None, 33),
], ids=["float", "bool", "integral_float"])
def test_non_int_channel_keeps_old_value(source, fill, old):
    if fill is None:
        img = np.full((4, 4, 4), 33, np.uint8)
    else:
        img = np.zeros((4, 4, 4), np.uint8)
        img[..., 0] = fill
        img[..., 3] = 255
    px, _ = ok(source, img)
    assert (px[..., 0] == old).all()
    if "9, b" in source:
        assert (px[..., 1] == 9).all()


def test_for_region_non_closure_is_script_error():
    out = both("for_region(0, 0, 2, 2, 42);", np.zeros((8, 8, 4), np.uint8))
    assert "closure" in out.error[0]


def test_async_engine_bug_still_sends_terminal_message(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("synthetic engine bug")

    def kinds(engine, **kw):
        monkeypatch.setattr(engine, "_run_script", boom)
        thread, messages = engine.execute_script_async(
            "let x = 1;", np.zeros((4, 4, 4), np.uint8), 4, 4, **kw)
        thread.join(timeout=30)
        assert not thread.is_alive()
        out = []
        while True:
            try:
                m = messages.get_nowait()
            except queue.Empty:
                return out
            out.append((m.kind, m.payload.message if m.kind == "error" else None))

    got = kinds(tengine, device="cpu")
    assert got == kinds(jengine)
    assert "error" in [k for k, _ in got]


def test_canvas_op_replay_keeps_selection_on_flips():
    from paintfe_tpu.core.canvas import Canvas as JCanvas
    from paintfe_tpu_torch.core.canvas import Canvas as TCanvas

    def replay(canvas_cls, api, engine, kind, w, h):
        c = canvas_cls.new(w, h, background=(1, 2, 3, 255))
        sel = np.zeros((h, w), np.uint8)
        sel[2:6, 2:6] = 255
        c.selection = sel
        engine.apply_canvas_ops(c, [api.CanvasOpRequest(kind=kind)], skip_layer=0)
        return c.selection, (c.width, c.height)

    for kind, w, h in [("flip_h", 16, 16), ("flip_v", 16, 16), ("rot180", 16, 16),
                       ("rot90cw", 16, 8)]:
        t_sel, t_dims = replay(TCanvas, tapi, tengine, kind, w, h)
        j_sel, j_dims = replay(JCanvas, japi, jengine, kind, w, h)
        assert t_dims == j_dims
        assert (t_sel is None) == (j_sel is None) == (kind == "rot90cw"), kind
        if t_sel is not None:
            np.testing.assert_array_equal(t_sel, j_sel)


# -- snapshot bulk-loop semantics ---------------------------------------------------


def test_get_pixel_inside_loop_reads_original():
    img = np.zeros((1, 4, 4), np.uint8)
    img[0, :, 0] = [10, 20, 30, 40]
    img[0, :, 3] = 255
    px, _ = ok("for_each_pixel(|x, y, r, g, b, a| {"
               " if x == 0 { [200, g, b, a] } else { [get_r(x - 1, y), g, b, a] } });", img)
    np.testing.assert_array_equal(px[0, :, 0], [200, 10, 20, 30])


def test_set_pixel_inside_loop_clobbered_on_success():
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 3] = 255
    px, _ = ok("for_each_pixel(|x, y, r, g, b, a| {"
               " set_pixel(0, 0, 111, 111, 111, 255); [r, 7, b, a] });", img)
    assert px[0, 0, 0] == 0 and (px[..., 1] == 7).all()


def test_set_pixel_inside_loop_persists_on_error():
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 3] = 255
    px, _ = ok("try { for_each_pixel(|x, y, r, g, b, a| {"
               " set_pixel(0, 0, 111, 0, 0, 255);"
               " if x == 1 { throw \"x\"; } [9, 9, 9, 255] }); } catch (e) {}", img)
    assert px[0, 0, 0] == 111
    assert not (px[..., 1] == 9).any()


def test_for_region_negative_sum_wraps_to_full_extent():
    px, _ = ok("for_region(2, 0, -5, 4, |x, y, r, g, b, a| { [255, g, b, a] });",
               np.zeros((4, 4, 4), np.uint8))
    assert (px[:, 2:, 0] == 255).all()
    assert (px[:, :2, 0] == 0).all()


def test_purity_scan_rejects_fnptr_call_and_curry():
    _, console = ok("let log = []; let f = |v| { log.push(v); v + 1 };"
                    "for_each_pixel(|x, y, r, g, b, a| { [f.call(r), g, b, a] });"
                    "print_line(`${log.len()}`);", np.zeros((4, 4, 4), np.uint8))
    assert console == ["16"]


def test_math_fn_ieee_corners():
    _, console = ok("""
        print_line(`${sqrt(-1.0)}`);
        print_line(`${pow(-2.0, 0.5)}`);
        print_line(`${pow(0.0, -1.0)}`);
        print_line(`${round(0.49999999999999994)}`);
        print_line(`${round(-0.5)}`);
        print_line(`${(0.49999999999999994).round()}`);
        print_line(`${(-1.5).round()}`);
        print_line(`${(-1.0).sqrt()}`);
        print_line(`${min(1.0, 0.0/0.0)}`);
        print_line(`${max(0.0/0.0, 2.0)}`);
        """)
    assert console == ["NaN", "NaN", "inf", "0.0", "-1.0", "0.0", "-2.0", "NaN", "1.0", "2.0"]
