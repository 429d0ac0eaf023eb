"""The port's public surface against the JAX package's, read with ``ast``
from both packages' sources (nothing is imported).

Every public module-level name (function, class, assigned name) of each
``vla_touch_tpu/**.py`` needs a counterpart in the mirrored
``vla_touch_tpu_torch/**.py``; every public method of such a class one in
the port's class (or a class it derives from in the same module); every
parameter of such a function or method one of the same name; and each
module's ``main`` the JAX one's argparse flags and no other but
``--device`` (which it must have where the port's ``main`` takes a device:
the host-only tools have none).  What the port leaves out on purpose
stands in the tables below, each entry with its reason; an entry that no
longer excuses anything fails the test too.  The checker itself is held on
two tiny trees, where a planted missing name, parameter and flag each fail
it.
"""

import ast
import fnmatch
import os

import pytest
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "vla_touch_tpu")
PORT_PKG = os.path.join(ROOT, "vla_touch_tpu_torch")

# JAX modules with no module of the same path: the port modules that take
# their place, and why
MODULES = {
    "ops/pallas_attention.py": (
        ("ops/flash_attention.py", "ops/flash_attention_q8.py"),
        "Pallas TPU kernels K1, K3, K4: hand-written CUDA kernels "
        "(csrc/flash_attention*.cu) behind these wrappers"),
    "ops/pallas_matmul.py": (
        ("ops/quant_matmul.py", "ops/w4_fused.py"),
        "Pallas TPU kernels K5-K10: CUDA kernels behind these wrappers"),
    "ops/pallas_unet.py": (
        ("ops/unet_kernels.py",),
        "Pallas TPU kernel K2: csrc/resblock.cu behind this wrapper"),
}

# JAX-only names ("module::name", "module::Class.method"; "*" matches any
# module or class), and why the port has none
NAMES = {
    "parallel/mesh.py::replicated": "a jax NamedSharding; torch.distributed keeps a "
                                    "replicated tensor whole on every rank",
    "parallel/mesh.py::data_sharded": "a jax NamedSharding; the port slices the batch per "
                                      "data rank (launch.host_local_batch)",
    "utils/image.py::pad_and_resize_jax": "the jax.image twin of pad_and_resize for traced "
                                          "arrays; the port has one resize",
    "ops/adam8bit.py::adamw8bit": "an optax transform; the port's 8-bit AdamW is "
                                  "train/optim.py's use_8bit_adam branch over this module",
    "models/encoders/t5_native.py::t5_encode_jit": "jax.jit of t5_encode; torch runs "
                                                   "t5_encode as it is",
    "*::*.setup": "flax's submodule hook; a torch module builds its submodules in __init__",
    "*::*.apply_v": "a flax method handle for module.apply(method=); the port calls the "
                    "submodule",
    "*::*.apply_s": "a flax method handle for module.apply(method=); the port calls the "
                    "submodule",
    "*::*.apply_b": "a flax method handle for module.apply(method=); the port calls the "
                    "submodule",
    "models/controllers/lstm.py::LSTMControllerModule.init_all": "flax init of every "
                                                                 "submodule; a torch module "
                                                                 "is built initialised",
}

# JAX parameter names the port spells in its own idiom ("*" as above; a
# bare pattern holds in every function)
PARAMS = {
    "params": "the weights are the torch module passed in",
    "*_params": "the weights are the torch module passed in",
    "key": "torch cannot replay jax.random: a torch.Generator, or the noise itself",
    "*_key": "torch cannot replay jax.random: a torch.Generator, or the noise itself",
    "unroll": "lax.scan's unroll; the port's loops are Python loops",
    "dtype": "a flax module's compute dtype; a torch module computes in its weights' dtype",
    "interpret": "Pallas's interpret mode; on CPU tensors a wrapper computes its plain version",
    "models/controllers/bridge.py::bridge_predict(ema_shadow)":
        "bridge.deployable binds the EMA shadow into the module passed in",
    "models/controllers/bridge.py::bridge_predict(unet_impl)":
        "flax taps or the Pallas block in JAX; the port's UNet takes K2 on the card",
    "models/controllers/unet1d_serve.py::unet_forward_stacked(kernel_size)":
        "the stacked weights' shape gives it",
    "models/controllers/unet1d_serve.py::unet_forward_stacked(fused)":
        "flax or the Pallas block in JAX; the port takes K2 on the card",
    "*::encode_images(cfg)": "the torch encoder module carries its config",
    "*::vit_encode_serve(cfg)": "the serving twin module carries its config",
    "*::encode_tactile_video(cfg)": "the encoder state's module carries its config",
    "train/rdt_loop.py::encode_images(vision_cfg)": "the torch tower carries its config",
    "models/rdt/quant_serve.py::forward_cached_quant(qd)":
        "JAX passes the quantized dense; the port's quantized linears dispatch themselves",
    "models/rdt/quant_serve.py::rdt_predict_action_quant(qparams)":
        "the int8/int4 twin is the module passed in",
    "models/rdt/quant_serve.py::rdt_predict_action_quant(matmul)":
        "'xla' or 'pallas' in JAX; the port's twin takes its kernels on the card",
    "ops/attention.py::dot_product_attention(use_pallas)":
        "the port's attention always goes through K1's wrapper",
    "ops/quant.py::quantize_linear(p)": "an nn.Linear in place of a flax kernel dict",
    "ops/quant.py::quantize_linear_w4(p)": "an nn.Linear in place of a flax kernel dict",
    "ops/quant.py::is_linear(p)": "an nn.Module in place of a flax subtree",
    "ops/quant.py::unpack_w4(K)": "the port reads K off the packed weight (twice its width)",
    "parallel/mesh.py::make_mesh(devices)":
        "torch.distributed: the default process group's ranks are the devices",
    "parallel/mesh.py::zero_sharding(tree)":
        "the optimizer state as name -> shape (shapes, transposed)",
    "train/rdt_train.py::shard_train_state(state_sh)":
        "a ShardPlan (plan) in place of a tree of shardings",
    "train/rdt_loop.py::RDTTrainer.train(mesh)":
        "the mesh is the process group's (parallel/launch.py)",
}


def _params(fn) -> list:
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return out + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _flags(tree) -> set:
    """Every flag string of every ``add_argument`` call in the module."""
    return {a.value for c in ast.walk(tree) if isinstance(c, ast.Call)
            and getattr(c.func, "attr", None) == "add_argument"
            for a in c.args if isinstance(a, ast.Constant) and isinstance(a.value, str)
            and a.value.startswith("-")}


def module_surface(path: str) -> dict:
    """One source file's public module level: ``names`` name -> parameters
    (functions), method name -> parameters (classes, with the methods of
    bases defined in the same file) or None (assigned names); ``main`` its
    parameters or None; ``flags`` its argparse flags."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls, seen=()):
        out = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
                out.update(methods(classes[base.id], seen + (cls.name,)))
        out.update({m.name: _params(m) for m in cls.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")})
        return out

    names, main = {}, None
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if n.name == "main":
                main = _params(n)
            if not n.name.startswith("_"):
                names[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            names[n.name] = methods(n)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    names.setdefault(t.id, None)
    return {"names": names, "main": main, "flags": _flags(tree)}


def package_surface(root: str) -> dict:
    """Relative path -> :func:`module_surface` of every ``.py`` under
    ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root).replace(os.sep, "/")] = module_surface(path)
    return out


def _excused(table: dict, key: str) -> str:
    """The first entry of ``table`` whose pattern matches ``key``, or ''."""
    return next((k for k in table if fnmatch.fnmatchcase(key, k)), "")


def _param_excused(table: dict, where: str, param: str) -> str:
    return (_excused(table, f"{where}({param})")
            or next((k for k in table if "(" not in k and fnmatch.fnmatchcase(param, k)), ""))


def surface_gaps(jax_root: str, port_root: str, modules=None, names=None, params=None):
    """(what the port lacks, table entries that excused nothing): each gap
    a string naming the module, name, parameter or flag."""
    modules = MODULES if modules is None else modules
    names = NAMES if names is None else names
    params = PARAMS if params is None else params
    jax, port = package_surface(jax_root), package_surface(port_root)
    gaps, used = [], set()

    def need(key: str, table: dict, hit: str) -> None:
        if hit:
            used.add(hit)
        else:
            gaps.append(key)

    for rel, js in sorted(jax.items()):
        if rel not in port:
            hit = rel if rel in modules else ""
            need(f"module {rel}", modules, hit)
            if hit:
                gaps.extend(f"module {p} (in place of {rel})"
                            for p in modules[rel][0] if p not in port)
            continue
        ps = port[rel]
        for name, info in sorted(js["names"].items()):
            where = f"{rel}::{name}"
            if name not in ps["names"]:
                need(where, names, _excused(names, where))
                continue
            theirs = ps["names"][name]
            if isinstance(info, list):
                for p in info:
                    if theirs is not None and p not in (theirs if isinstance(theirs, list)
                                                        else []):
                        need(f"{where}({p})", params, _param_excused(params, where, p))
            elif isinstance(info, dict):
                mine = theirs if isinstance(theirs, dict) else {}
                for m, mp in sorted(info.items()):
                    mwhere = f"{where}.{m}"
                    if m not in mine:
                        need(mwhere, names, _excused(names, mwhere))
                        continue
                    for p in mp:
                        if p not in mine[m]:
                            need(f"{mwhere}({p})", params, _param_excused(params, mwhere, p))
        if js["main"] is not None:
            want = set(js["flags"])
            if ps["main"] is not None and "device" in ps["main"]:
                want.add("--device")
            gaps.extend(f"{rel}::main flag {f}" for f in sorted(want - ps["flags"]))
            gaps.extend(f"{rel}::main extra flag {f}"
                        for f in sorted(ps["flags"] - want - {"--device"}))
    unused = [k for t in (modules, names, params) for k in t if k not in used]
    return gaps, unused


def test_port_surface_covers_the_jax_package():
    gaps, unused = surface_gaps(JAX_PKG, PORT_PKG)
    assert gaps == [], "the port lacks:\n" + "\n".join(gaps)
    assert unused == [], "table entries that excuse nothing:\n" + "\n".join(unused)


def test_every_table_entry_names_a_reason():
    for rel, (ports, reason) in MODULES.items():
        assert ports and len(reason) > 20, rel
    for table in (NAMES, PARAMS):
        for key, reason in table.items():
            assert isinstance(reason, str) and len(reason) > 20, key


def _write_tree(root, files: dict):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return str(root)


TINY = {
    "a.py": "def f(x, y=1):\n    pass\n\n\nclass C:\n    def m(self, z):\n        pass\n\n\n"
            "LIMIT = 3\n",
    "sub/b.py": "def main(argv=None):\n    import argparse\n    p = argparse.ArgumentParser()\n"
                "    p.add_argument('--flag')\n    p.add_argument('--other', type=int)\n",
}


@pytest.mark.parametrize("plant,want", [
    (None, []),
    (("a.py", "def f(x, y=1):", "def g(x, y=1):"), ["a.py::f"]),
    (("a.py", "def f(x, y=1):", "def f(x):"), ["a.py::f(y)"]),
    (("a.py", "def m(self, z):", "def n(self, z):"), ["a.py::C.m"]),
    (("a.py", "def m(self, z):", "def m(self):"), ["a.py::C.m(z)"]),
    (("a.py", "LIMIT = 3", "LIMITS = 3"), ["a.py::LIMIT"]),
    (("sub/b.py", "    p.add_argument('--other', type=int)\n", ""),
     ["sub/b.py::main flag --other"]),
    (("sub/b.py", "def main(argv=None):", "def main(argv=None, device=None):"),
     ["sub/b.py::main flag --device"]),
    (("sub/b.py", "'--other'", "'--others'"),
     ["sub/b.py::main flag --other", "sub/b.py::main extra flag --others"]),
])
def test_checker_fails_on_a_planted_gap(tmp_path, plant, want):
    """The port tree is the JAX tree with one thing planted away: a name,
    a parameter, a method, a method's parameter, an assigned name, a flag,
    or a ``main`` that takes a device without its ``--device`` flag."""
    jax_root = _write_tree(tmp_path / "jax", TINY)
    port = dict(TINY)
    if plant is not None:
        rel, old, new = plant
        assert old in port[rel]
        port[rel] = port[rel].replace(old, new)
    port_root = _write_tree(tmp_path / "port", port)
    assert surface_gaps(jax_root, port_root, {}, {}, {}) == (want, [])


def test_checker_tables_excuse_and_report_stale_entries(tmp_path):
    """A planted gap passes when a table names it, a port main with a
    device passes with ``--device``, a missing module passes when its
    stand-ins exist, and an entry that excuses nothing is reported."""
    jax_root = _write_tree(tmp_path / "jax", dict(TINY, **{"k.py": "def kern(x):\n    pass\n"}))
    port = {"a.py": TINY["a.py"].replace("def f(x, y=1):", "def f(x):").replace(
        "LIMIT = 3", ""),
        "sub/b.py": TINY["sub/b.py"].replace("argv=None", "argv=None, device=None") + (
            "    p.add_argument('--device')\n"),
        "k_port.py": "def kernel(x):\n    pass\n"}
    port_root = _write_tree(tmp_path / "port", port)
    gaps, unused = surface_gaps(
        jax_root, port_root, {"k.py": (("k_port.py",), "replaced")},
        {"a.py::LIMIT": "gone", "*::*.unused": "stale"}, {"y": "renamed"})
    assert gaps == []
    assert unused == ["*::*.unused"]
