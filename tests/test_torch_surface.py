"""The port's public surface against the JAX package's, without importing
JAX: every module of ygz_slam_tpu/ is parsed with `ast`, and each public
name it defines must exist in the counterpart module of ygz_slam_tpu_torch/
(the same path), which is imported:

- each top-level function and class (defined there, or imported under that
  name, as the port's `ops/hamming.popcount_u32` is);
- each name a package's `__init__.py` re-exports;
- each public method and property of each class (fields are data: a
  NamedTuple's fields follow the layout, as `sparse_align.LevelRef`'s TPU
  lane packs do not, and the parity tests build each structure).

The one allow-list, EXCLUDED, names what the port leaves out on purpose,
each with its reason; an entry that no longer matches a JAX name fails
too.  A second test parses every module of the port and fails on an import
of `jax` or of the JAX package."""
import ast
import importlib
import os

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "ygz_slam_tpu", "ygz_slam_tpu_torch"

EXCLUDED = {
    "native.py": "the ctypes bindings of the JAX package's C library (native/); the port keeps "
                 "numpy copies of the entry points it calls (map/memory.py: alloc_kf_slot, "
                 "free_rows, partition_obs)",
    "ops/pallas/": "the Pallas TPU kernels; the port's kernels are hand-written CUDA (csrc/), "
                   "bound and held to their plain versions in ops/kernels/",
    "parallel/mesh.py:shard_spec": "returns a jax.sharding.NamedSharding; a torch tensor carries "
                                   "no sharding, and Mesh.local_rows cuts a rank's rows instead",
    "utils/synthetic.py:photo_textures": "reads the DBoW3 sample images "
                                         "(thirdparty/DBoW3/utils/images), which are not in the "
                                         "repository",
    "utils/profiling.py:append_bench_log": "a JSON-lines log that nothing in the port reads",
}


def _jax_modules() -> list[str]:
    """Paths of the JAX package's modules relative to it, outside EXCLUDED."""
    root = os.path.join(REPO, JAX_PKG)
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            if f.endswith(".py") and not any(rel == e or rel.startswith(e) for e in EXCLUDED
                                             if ":" not in e):
                out.append(rel)
    return sorted(out)


def _public_names(rel: str) -> list[tuple[str, str | None]]:
    """(name, None) for each public top-level function, class and, in an
    `__init__.py`, re-export of the JAX module; (method, class) for each
    public method and property of its classes."""
    with open(os.path.join(REPO, JAX_PKG, rel)) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append((node.name, None))
            if isinstance(node, ast.ClassDef):
                out.extend((item.name, node.name) for item in node.body
                           if isinstance(item, ast.FunctionDef) and not item.name.startswith("_"))
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__.py") and node.level:
            out.extend((a.asname or a.name, None) for a in node.names)
    return [(n, c) for n, c in out if f"{rel}:{n if c is None else c + '.' + n}" not in EXCLUDED]


def _port_module(rel: str):
    name = PORT_PKG + "." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_surface(rel):
    """Every public name of the JAX module has its counterpart in the port."""
    assert os.path.exists(os.path.join(REPO, PORT_PKG, rel)), f"no {PORT_PKG}/{rel}"
    mod = _port_module(rel)
    missing = []
    for name, cls in _public_names(rel):
        if cls is None:
            if not hasattr(mod, name):
                missing.append(name)
        elif not hasattr(getattr(mod, cls, None), name):
            missing.append(f"{cls}.{name}")
    assert not missing, f"{PORT_PKG}/{rel} lacks {missing}"


def test_excluded_entries_name_jax_code():
    """Each allow-list entry names a JAX module, folder or public name that
    exists, and the port really lacks it."""
    assert len(EXCLUDED) == 5 and all(EXCLUDED.values())
    for entry in EXCLUDED:
        rel, _, name = entry.partition(":")
        assert os.path.exists(os.path.join(REPO, JAX_PKG, rel)), entry
        if name:
            with open(os.path.join(REPO, JAX_PKG, rel)) as f:
                tree = ast.parse(f.read())
            assert name in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}, entry
            assert not hasattr(_port_module(rel), name), f"{entry} is ported: drop it here"
        else:
            assert not os.path.exists(os.path.join(REPO, PORT_PKG, rel)), entry


def _port_files() -> list[str]:
    root = os.path.join(REPO, PORT_PKG)
    return sorted(os.path.relpath(os.path.join(d, f), REPO).replace(os.sep, "/")
                  for d, _, files in os.walk(root) for f in files if f.endswith(".py"))


def test_port_imports_no_jax():
    """No module of the port (nor chip_smoke.py) imports jax or the JAX
    package."""
    bad = []
    for rel in _port_files() + ["chip_smoke.py"]:
        with open(os.path.join(REPO, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{rel}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", JAX_PKG)]
    assert not bad, bad
