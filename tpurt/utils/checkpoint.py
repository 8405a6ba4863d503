"""Checkpoint/resume for scenes and optimization state (SURVEY.md §5
"Checkpoint/resume": the reference is a stateless renderer with none; the
new framework's inverse-rendering loops need restartable state).

The default format is a self-contained npz (any `*.npz` path): leaves
stored as arrays plus a STRUCTURAL JSON spec of the pytree
(node kinds + class names + field names).  No pickle anywhere — loading an
untrusted npz can at worst construct allowlisted dataclass/namedtuple types
from tpurt/optax with array fields, never execute embedded code.  Any
other path is an orbax-checkpoint directory; orbax is imported only then.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

import jax
import numpy as np

#: modules whose dataclasses/namedtuples may be reconstructed from a spec
_ALLOWED_MODULE_PREFIXES = ("tpurt.", "tpurt", "optax", "jax.", "flax.")


def _to_spec(x, leaves: list):
    """Pytree → JSON-able structural spec; arrays appended to `leaves`."""
    if x is None:
        return {"t": "none"}
    if isinstance(x, (bool, int, float, str)):
        return {"t": "py", "v": x}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = type(x)
        return {
            "t": "dc",
            "cls": f"{cls.__module__}:{cls.__qualname__}",
            "fields": {
                f.name: _to_spec(getattr(x, f.name), leaves)
                for f in dataclasses.fields(x)
            },
        }
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # namedtuple
        cls = type(x)
        return {
            "t": "nt",
            "cls": f"{cls.__module__}:{cls.__qualname__}",
            "items": [_to_spec(v, leaves) for v in x],
        }
    if isinstance(x, tuple):
        return {"t": "tuple", "items": [_to_spec(v, leaves) for v in x]}
    if isinstance(x, list):
        return {"t": "list", "items": [_to_spec(v, leaves) for v in x]}
    if isinstance(x, dict):
        items = sorted(x.items(), key=lambda kv: str(kv[0]))
        return {
            "t": "dict",
            "keys": [[("i" if isinstance(k, int) else "s"), str(k)]
                     for k, _ in items],
            "items": [_to_spec(v, leaves) for _, v in items],
        }
    # array leaf
    leaves.append(np.asarray(x))
    return {"t": "leaf", "i": len(leaves) - 1}


def _resolve_class(ref: str):
    mod_name, qual = ref.split(":")
    if not any(
        mod_name == p.rstrip(".") or mod_name.startswith(p)
        for p in _ALLOWED_MODULE_PREFIXES
    ):
        raise ValueError(
            f"checkpoint references class from disallowed module {mod_name!r}"
        )
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _from_spec(spec, leaves):
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "leaf":
        return leaves[spec["i"]]
    if t == "tuple":
        return tuple(_from_spec(s, leaves) for s in spec["items"])
    if t == "list":
        return [_from_spec(s, leaves) for s in spec["items"]]
    if t == "dict":
        keys = [int(k) if kind == "i" else k for kind, k in spec["keys"]]
        return {
            k: _from_spec(s, leaves) for k, s in zip(keys, spec["items"])
        }
    if t == "dc":
        cls = _resolve_class(spec["cls"])
        if not dataclasses.is_dataclass(cls):
            raise ValueError(f"{spec['cls']} is not a dataclass")
        return cls(**{k: _from_spec(s, leaves)
                      for k, s in spec["fields"].items()})
    if t == "nt":
        cls = _resolve_class(spec["cls"])
        if not (issubclass(cls, tuple) and hasattr(cls, "_fields")):
            raise ValueError(f"{spec['cls']} is not a namedtuple")
        return cls(*[_from_spec(s, leaves) for s in spec["items"]])
    raise ValueError(f"unknown spec node {t!r}")


def save_pytree(path, tree):
    """Save any jax pytree.  `*.npz` → self-contained npz (exact pytree
    round-trip, no target needed); anything else → orbax directory."""
    if str(path).endswith(".npz"):
        leaves: list = []
        spec = _to_spec(tree, leaves)
        arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
        spec_arr = np.frombuffer(
            json.dumps(spec).encode("utf-8"), np.uint8
        ).copy()
        with open(path, "wb") as f:
            np.savez(f, __spec__=spec_arr, **arrays)
        return path
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, force=True)
    ckptr.wait_until_finished()
    return path


def load_pytree(path, like=None):
    """Load a pytree saved by save_pytree.  `like` (an example pytree) is
    required for orbax directories, optional for npz files."""
    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        return ckptr.restore(os.path.abspath(path), target=like)
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode("utf-8"))
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
        # ALWAYS rebuild through the spec: the npz leaf order is the spec's
        # (dict keys str-sorted, python scalars inline), which differs from
        # jax.tree_util's flatten order (keys sorted by value, scalars as
        # leaves) — unflattening raw npz leaves into like's treedef would
        # silently permute int-keyed dict entries.  `like`, when given,
        # only validates/adopts the target structure via a jax-order
        # reflatten of the reconstructed tree.
        tree = _from_spec(spec, leaves)
        if like is not None:
            treedef = jax.tree_util.tree_structure(like)
            return jax.tree_util.tree_unflatten(
                treedef, jax.tree_util.tree_leaves(tree))
        return tree
