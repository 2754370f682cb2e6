"""The port's public names and arguments against the JAX package's.

Both packages are read with ``ast``; neither is imported. For every module
of the JAX package, the port's module at the same path (the Pallas
kernels' ``ops/pallas/X.py`` at ``ops/cuda/X.py``) must define or import
every public module-level name the JAX module defines, and every name its
``__init__`` re-exports. For every public module-level function, and every
public method (``__init__`` and ``__call__`` included) of a public class,
that both modules define, each argument of the JAX signature must be an
argument of the port's. The exceptions are the two tables below, each
entry with its reason: names and arguments with no counterpart by nature.
Every entry must still be needed, so the tables cannot grow stale.

Not compared: the fields of Flax modules and of config dataclasses, which
are not arguments of a ``def`` (the port's models are ``nn.Module``s that
take their widths as ``__init__`` arguments; the configs' ``line_chunk``
and ``backend`` are XLA settings).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "a_robust_registration_loss_tpu"
PORT = JAX + "_torch"

# (JAX module, name, reason); "*" for every name of the module
NAMES = [
    ("utils/compile_cache.py", "*", "caches compiled XLA programs; PyTorch compiles nothing"),
    ("utils/freshness.py", "*", "stamps the JAX package's sources for its test tiers"),
    ("parallel/mesh.py", "batch_sharding", "a JAX sharding spec; ranks hold their own rows"),
    ("parallel/mesh.py", "line_sharding", "a JAX sharding spec; ranks hold their own lines"),
    ("parallel/mesh.py", "replicated", "a JAX sharding spec; every rank holds a copy"),
    ("parallel/mesh.py", "constrain", "a JAX sharding constraint inside jit"),
    ("train/dcp.py", "init_params", "Flax parameter init; the port's modules hold weights"),
    ("train/fmr.py", "init_params", "Flax parameter init; the port's modules hold weights"),
    ("train/rpmnet.py", "init_params", "Flax parameter init; the port's modules hold weights"),
    ("train/dcp.py", "make_steps", "builds jitted Flax steps; the port's steps are functions"),
    ("train/fmr.py", "make_steps", "builds jitted Flax steps; the port's steps are functions"),
    ("train/rpmnet.py", "make_steps", "builds jitted Flax steps; the port's steps are functions"),
    ("models/transplant.py", "dcp_from_state_dict",
     "reference state dict to Flax; the port's names are the reference's (dcp_from_flax)"),
    ("models/transplant.py", "fmr_encoder_from_state_dict",
     "reference state dict to Flax; the port's names are the reference's (fmr_from_flax)"),
    ("models/transplant.py", "fmr_decoder_from_state_dict",
     "reference state dict to Flax; the port's names are the reference's (fmr_from_flax)"),
    ("models/transplant.py", "fmr_from_state_dict",
     "reference state dict to Flax; the port's names are the reference's (fmr_from_flax)"),
    ("models/transplant.py", "merge_params", "merges Flax parameter trees"),
    ("data/dataset.py", "jnp_asarray", "jax.numpy.asarray behind a lazy import"),
    ("ops/pallas/intersect.py", "intersect_stage1_pair_lanemajor",
     "the TPU's lane-major (6, L) line layout; the CUDA kernel reads lines row-major"),
]

ROUND_BUDGET = ("the JAX round budget: no caller in either package sets it, and on the H100 "
                "it cost 1.27 to 1.89 times the one-stream call")

# (JAX module, function, argument, reason); "*" for every module or function
ARGUMENTS = [
    ("*", "*", "backend", "picks XLA or Pallas; the port's wrappers pick by the tensor's device"),
    ("*", "*", "interpret", "Pallas interpret mode; a CPU tensor runs the plain version"),
    ("*", "*", "key", "a jax.random key; the port takes its uniforms or a torch.Generator"),
    ("ops/lines.py", "sample_lines", "n", "the count of its draw; the port takes its uniforms"),
    ("ops/lines.py", "resample_lines", "rounds", ROUND_BUDGET),
    ("ops/lines.py", "resample_lines", "fast_rounds", ROUND_BUDGET),
    ("ops/metric.py", "*", "line_chunk", "XLA's chunking of the line axis"),
    ("ops/geometry.py", "square_distance", "precision", "XLA's matmul precision"),
    ("ops/pallas/intersect.py", "*", "tl", "a Pallas tile size"),
    ("ops/pallas/intersect.py", "*", "tf", "a Pallas tile size"),
    ("ops/pallas/resample.py", "sample_and_hit", "tc", "a Pallas tile size"),
    ("parallel/mesh.py", "make_mesh", "devices", "JAX devices; the mesh's ranks are processes"),
    ("parallel/mesh.py", "shard_batch", "tree", "any JAX pytree; the port's batches are dicts"),
    ("data/dataset.py", "*", "sharding", "a JAX sharding of the cached dataset"),
    ("train/classical.py", "*", "optimizer", "an optax optimizer; the port writes Adam out"),
    ("train/harness.py", "guarded_update", "optimizer",
     "an optax optimizer; the port writes Adam out"),
    ("train/harness.py", "*", "params", "Flax parameters; the port's modules hold their weights"),
    ("train/dcp.py", "evaluate", "params", "Flax parameters; the port's modules hold weights"),
    ("train/fmr.py", "evaluate", "params", "Flax parameters; the port's modules hold weights"),
    ("train/rpmnet.py", "evaluate", "params", "Flax parameters; the port's modules hold weights"),
]


def _modules():
    root = os.path.join(REPO, JAX)
    out = []
    for base, dirs, names in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += sorted(os.path.relpath(os.path.join(base, n), root).replace(os.sep, "/")
                      for n in names if n.endswith(".py"))
    return out


MODULES = _modules()


def _port_path(module):
    if module.startswith("ops/pallas/"):
        module = "ops/cuda/" + module[len("ops/pallas/"):]
    return os.path.join(REPO, PORT, module)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _names(tree, imports):
    """Module-level names a module defines (and imports, if ``imports``)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                out |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _public(name):
    return not name.startswith("_") or name == "__version__"


def _signatures(tree):
    """{function or Class.method: its argument names}, public ones only."""
    out = {}

    def args(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                + [a.vararg, a.kwarg] if x is not None]

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out[node.name] = args(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (_public(m.name) or m.name in ("__init__", "__call__"))):
                    out[f"{node.name}.{m.name}"] = args(m)
    return out


def _missing_names(module):
    """The JAX module's public names that the port's module lacks."""
    port = _port_path(module)
    want = {n for n in _names(_tree(os.path.join(REPO, JAX, module)),
                              module.endswith("__init__.py")) if _public(n)}
    have = _names(_tree(port), True) if os.path.exists(port) else set()
    return sorted(want - have)


def _missing_arguments(module):
    """(function, argument) of the JAX module that the port's lacks, over
    the functions and methods both define."""
    port = _port_path(module)
    if not os.path.exists(port):
        return []
    want = _signatures(_tree(os.path.join(REPO, JAX, module)))
    have = _signatures(_tree(port))
    return [(fn, a) for fn, args in sorted(want.items()) if fn in have
            for a in args if a not in have[fn] and a not in ("self", "cls")]


def _name_exempt(module, name):
    return [e for e in NAMES if e[0] == module and e[1] in ("*", name)]


def _argument_exempt(module, fn, arg):
    return [e for e in ARGUMENTS if e[0] in ("*", module) and e[1] in ("*", fn.split(".")[-1])
            and e[2] == arg]


@pytest.mark.parametrize("module", MODULES)
def test_public_names_exist_in_the_port(module):
    missing = [n for n in _missing_names(module) if not _name_exempt(module, n)]
    assert not missing, f"{PORT}/{module} lacks {missing}"


@pytest.mark.parametrize("module", MODULES)
def test_arguments_exist_in_the_port(module):
    missing = [(fn, a) for fn, a in _missing_arguments(module)
               if not _argument_exempt(module, fn, a)]
    assert not missing, f"{PORT}/{module} lacks the arguments {missing}"


def test_every_exemption_is_needed():
    used = {e for m in MODULES for n in _missing_names(m) for e in _name_exempt(m, n)}
    used |= {e for m in MODULES for fn, a in _missing_arguments(m)
             for e in _argument_exempt(m, fn, a)}
    assert [e for e in NAMES + ARGUMENTS if e not in used] == []
    assert all(e[-1] for e in NAMES + ARGUMENTS)  # every entry gives its reason
