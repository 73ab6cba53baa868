"""The guard against JAX and the JAX package, by whole top-level names."""
import ast
import importlib.util
import subprocess
import sys
import types

from pbb import manifest

RUN = manifest.BENCH_DIR / "run.py"


def _run_module():
    spec = importlib.util.spec_from_file_location("pbb_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_repro_torch_passes_and_repro_fails(monkeypatch):
    run = _run_module()
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.kernels", types.ModuleType("x"))
    assert "repro" in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert {"repro", "jaxlib"} <= set(run.loaded_forbidden())


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import pbb.runner, pbb.serve, pbb.check, reference.decoder\n"
            "pbb.serve._program()\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}\n"
            "print(sorted(bad))" % (str(manifest.BENCH_DIR),
                                    str(manifest.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def _code(path) -> str:
    """A module's source after its docstring."""
    src = path.read_text()
    body = ast.parse(src).body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        src = "\n".join(src.splitlines()[body[0].end_lineno:])
    return src


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((manifest.BENCH_DIR / "reference").glob("*.py")):
        src = _code(path)
        assert "repro" not in src and "jax" not in src, path.name
        assert "pbb" not in src, path.name


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(RUN), "--workload",
                          "opt-lora-chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
