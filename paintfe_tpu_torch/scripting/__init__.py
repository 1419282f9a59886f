"""The Rhai scripting engine of the port.

rhai_ast.py, interp.py and pycompile.py are copies of the JAX package's
JAX-free front end with only their import lines renamed (the JAX package's
scripting/__init__ imports JAX, so they cannot be imported from there);
tests/test_torch_scripting.py guards them against drift.
"""

from paintfe_tpu_torch.scripting.api import CanvasOpRequest, ScriptContext  # noqa: F401
from paintfe_tpu_torch.scripting.engine import (  # noqa: F401
    ScriptError,
    ScriptMessage,
    apply_canvas_ops,
    compile_script,
    execute_script_async,
    execute_script_sync,
)
