"""Checkpoints carrying regression-target statistics.

The port writes a ``torch.save`` of ``{"state_dict", "reg_stats", "arch",
"epoch", "best_loss"}`` (``.pt``). ``reg_stats`` MUST ride along: inference
denormalizes the regression outputs with it. Names and the ``model_best``
copy follow the JAX package's ``train/checkpoint.py`` with ``.pt`` for
``.msgpack``.

:func:`load_checkpoint` reads four formats into that dict:

* the port's ``.pt``;
* the JAX package's ``checkpoint.msgpack`` (flax msgpack, read by
  :mod:`.flax_msgpack`; its flax trees mapped by
  ``models/convert.py:state_dict_from_jax``);
* the JAX package's orbax checkpoint directories
  (``save_checkpoint_orbax``), read through ``tensorstore`` where it
  imports (:func:`read_orbax`), their trees mapped as msgpack trees are;
* a reference SSN or binary ``.pth``/``.pth.tar`` (``module.``-prefixed,
  ``reg_stats`` possibly a numpy array; ``models/convert.py:
  ssn_state_from_reference``), in torch's zip format or its older one.

:func:`save_checkpoint_orbax` writes the JAX package's orbax directory of
a port ``state_dict`` (``models/convert.py:jax_from_state_dict``), where
``tensorstore`` imports.

Torch files load with ``weights_only=True``: nothing but tensors,
containers and numbers is unpickled, plus, by name, the numpy globals that
rebuild an array or a scalar (:data:`NUMPY_GLOBALS`, and the numeric
dtypes' classes, :data:`NUMPY_DTYPES`).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def checkpoint_name(snapshot_pref: str, dataset: str, arch: str,
                    modality: str, filename: str = "checkpoint.pt") -> str:
    """``ssn<pref>_<dataset>_<arch>_<modality>_checkpoint.pt``
    (``binary_checkpoint.pt`` for ``binary_train``)."""
    return "ssn" + "_".join((snapshot_pref, dataset, arch, modality.lower(),
                             filename))


def best_name(path: str) -> str:
    """The ``model_best`` copy of ``path``: ``checkpoint`` in the file name
    becomes ``model_best``, any other name gains a ``_model_best`` suffix."""
    head, tail = os.path.split(path)
    if "checkpoint" in tail:
        return os.path.join(head, tail.replace("checkpoint", "model_best"))
    root, ext = os.path.splitext(tail)
    return os.path.join(head, root + "_model_best" + ext)


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    reg_stats, arch: str = "", epoch: int = 0,
                    best_loss: float = float("inf"),
                    is_best: bool = False) -> None:
    """Write a checkpoint atomically (temp file + rename); with ``is_best``
    also its ``model_best`` copy (:func:`best_name`). ``state_dict`` is the
    bare model's: a ``DistributedDataParallel`` wrapper's ``module.`` keys
    raise (the JAX package's ``convert_torch_ssn_checkpoint`` reads this
    format). In a data-parallel run only rank 0 calls this."""
    wrapped = [k for k in state_dict if k.startswith("module.")]
    if wrapped:
        raise ValueError(f"state_dict keys {wrapped[:3]} carry a "
                         "DistributedDataParallel 'module.' prefix: save the "
                         "unwrapped model's state_dict")
    state = {"state_dict": {k: v.detach().cpu() for k, v in
                            state_dict.items()},
             "reg_stats": (torch.as_tensor(np.asarray(reg_stats))
                           if reg_stats is not None else None),
             "arch": arch, "epoch": int(epoch),
             "best_loss": float(best_loss)}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, best_name(path))


#: the numpy globals a torch pickle of a numpy array or scalar names (numpy
#: 2's module path and numpy 1's), allowed by name and nothing else; with
#: them, the classes of the numeric dtypes (numpy >= 1.25 rebuilds a dtype
#: as an instance of its own class)
NUMPY_GLOBALS = ("numpy._core.multiarray._reconstruct",
                 "numpy.core.multiarray._reconstruct",
                 "numpy._core.multiarray.scalar",
                 "numpy.core.multiarray.scalar", "numpy.ndarray",
                 "numpy.dtype")
NUMPY_DTYPES = ("bool", "int8", "uint8", "int16", "uint16", "int32",
                "uint32", "int64", "uint64", "float16", "float32", "float64")


def _numpy_safe_globals() -> list:
    try:
        from numpy._core import multiarray
    except ImportError:     # numpy 1
        from numpy.core import multiarray

    objs = {"_reconstruct": multiarray._reconstruct,
            "scalar": multiarray.scalar, "ndarray": np.ndarray,
            "dtype": np.dtype}
    named = [(objs[name.rsplit(".", 1)[1]], name) for name in NUMPY_GLOBALS]
    classes = {type(np.dtype(t)) for t in NUMPY_DTYPES} - {np.dtype}
    return named + sorted(classes, key=lambda c: c.__name__)


#: the files that make a directory an orbax checkpoint (its tree's
#: metadata and the OCDBT manifest of its arrays)
ORBAX_FILES = ("_METADATA", "manifest.ocdbt")


def _orbax_leaf(a: np.ndarray):
    """A leaf as the port's trees hold it: a bfloat16 array (ml_dtypes)
    becomes a ``torch.bfloat16`` tensor bit for bit, as the msgpack reader
    gives it; any other dtype stays numpy."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return a


def _tensorstore(directory: str, doing: str):
    """``tensorstore``, or ``ImportError`` naming it where it does not
    import (the port's only use of it is orbax directories)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{directory} is an orbax checkpoint directory: {doing} it needs "
            f"the tensorstore package, which does not import here ({e}); "
            "use a checkpoint.msgpack, a .pt or a .pth") from e
    return ts


#: the OCDBT configuration orbax 0.11 gives its kvstore, and the zarr
#: compressor of its arrays
ORBAX_OCDBT_CONFIG = {"max_inline_value_bytes": 1024,
                      "max_decoded_node_bytes": 100000000,
                      "version_tree_arity_log2": 4,
                      "compression": {"id": "zstd"}}
ORBAX_COMPRESSOR = {"id": "zstd", "level": 1}
#: ``_CHECKPOINT_METADATA``'s handler, as orbax's StandardCheckpointer
#: names it
ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler")


def _orbax_leaves(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` of a nested dict, an empty dict a leaf of its own
    (orbax writes it as a ``Dict`` it skips on restore)."""
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from _orbax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_checkpoint_orbax(directory: str, state_dict: Mapping[str, Any],
                          reg_stats, arch: str = "", epoch: int = 0,
                          best_loss: float = float("inf")) -> None:
    """What the JAX package's ``save_checkpoint_orbax`` writes, from a port
    ``state_dict``: ``epoch`` (int64), ``best_loss`` (float64),
    ``reg_stats``, and the flax ``params`` and ``batch_stats`` of
    ``models/convert.py:jax_from_state_dict(state_dict, arch)``, each an
    array in the ``ocdbt`` kvstore over the directory (orbax's
    configuration, one zarr array a tree path joined with ``.``, one
    chunk, zstd; ``use_zarr3`` false), with orbax 0.11's ``_METADATA`` and
    ``_CHECKPOINT_METADATA``; the ``ARCH`` sidecar. Written into
    ``<directory>.tmp_ocp``, which then replaces ``directory``, as JAX
    does. Where ``tensorstore`` does not import, ``ImportError`` naming
    it. :func:`read_orbax` and the JAX package's ``load_checkpoint_orbax``
    read it back."""
    from ..models.convert import jax_from_state_dict

    ts = _tensorstore(directory, "writing")
    params, stats = jax_from_state_dict(state_dict, arch)
    tree = {"epoch": np.int64(epoch), "best_loss": np.float64(best_loss),
            "reg_stats": np.asarray(reg_stats), "params": params,
            "batch_stats": stats}
    final = os.path.abspath(directory)
    tmp = final + ".tmp_ocp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    started = time.time_ns()
    kvstore = {"driver": "ocdbt", "base": "file://" + tmp,
               "config": ORBAX_OCDBT_CONFIG}
    context = ts.Context()
    meta, writes = {}, []
    for path, leaf in sorted(_orbax_leaves(tree)):
        if isinstance(leaf, dict):      # empty: orbax skips it on restore
            value = {"value_type": "Dict", "skip_deserialize": True}
        else:
            a = np.asarray(leaf, order="C")
            spec = {"driver": "zarr",
                    "kvstore": dict(kvstore, path=".".join(path)),
                    "metadata": {"shape": list(a.shape),
                                 "chunks": list(a.shape),
                                 "dtype": a.dtype.str,
                                 "compressor": ORBAX_COMPRESSOR,
                                 "fill_value": None,
                                 "dimension_separator": "."}}
            store = ts.open(spec, create=True, context=context).result()
            writes.append(store.write(a))
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        meta[str(path)] = {"key_metadata": [{"key": k, "key_type": 2}
                                            for k in path],
                           "value_metadata": value}
    for w in writes:
        w.result()
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": ORBAX_HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(final, "ARCH"), "w") as f:
        f.write(arch)


def read_orbax(directory: str) -> Dict[str, Any]:
    """The contents of a JAX ``save_checkpoint_orbax`` directory as the JAX
    package's ``load_checkpoint_orbax`` returns them: ``params``,
    ``batch_stats``, ``reg_stats``, ``epoch`` (int), ``best_loss`` (float),
    ``arch`` (the ``ARCH`` sidecar, ``""`` without one) and ``extra``
    (``{}``). Each array is read with ``tensorstore`` (imported here and
    nowhere else): the ``ocdbt`` kvstore over the directory, the ``zarr``
    driver (``zarr3`` where ``_METADATA`` says ``use_zarr3``), keyed by its
    tree path joined with ``.``. Leaves orbax marked ``skip_deserialize``
    (an empty dict or list, None) come back as that value.

    A directory without :data:`ORBAX_FILES` raises ``ValueError`` naming
    what is missing; where tensorstore does not import, ``ImportError``
    naming it."""
    missing = [f for f in ORBAX_FILES
               if not os.path.isfile(os.path.join(directory, f))]
    if missing:
        raise ValueError(
            f"{directory} is a directory but not an orbax checkpoint: it "
            f"has no {' and no '.join(missing)} (pass an orbax checkpoint "
            "directory, a checkpoint.msgpack, a .pt or a .pth)")
    ts = _tensorstore(directory, "reading")
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    kvstore = {"driver": "ocdbt",
               "base": "file://" + os.path.abspath(directory)}
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    skipped = {"Dict": dict, "List": list, "None": lambda: None}
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            if value["value_type"] not in skipped:
                raise ValueError(f"{directory}: leaf {'.'.join(keys)} of "
                                 f"type {value['value_type']} is not read")
            leaf = skipped[value["value_type"]]()
        else:
            leaf = _orbax_leaf(ts.open(
                {"driver": driver,
                 "kvstore": dict(kvstore, path=".".join(keys))},
                open=True).result().read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    arch_file = os.path.join(directory, "ARCH")
    arch = ""
    if os.path.exists(arch_file):
        with open(arch_file) as f:
            arch = f.read()
    return {"epoch": int(tree["epoch"]), "arch": arch,
            "best_loss": float(tree["best_loss"]),
            "reg_stats": np.asarray(tree["reg_stats"]),
            "params": tree["params"], "batch_stats": tree["batch_stats"],
            "extra": {}}


def read_file(path: str) -> Tuple[str, Any]:
    """``(format, content)`` of a checkpoint: ``("orbax", tree)`` for a
    directory (:func:`read_orbax`); for a file, the format read from its
    first bytes: ``("torch", ...)`` for torch's zip or older pickle format
    (``torch.load`` on the CPU, ``weights_only=True``, the numpy globals of
    :data:`NUMPY_GLOBALS` allowed) or ``("msgpack", tree)`` for a map,
    flax's top level (:mod:`.flax_msgpack`). Anything else raises
    ``ValueError`` naming it."""
    if os.path.isdir(path):
        return "orbax", read_orbax(path)
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80
                             and 2 <= head[1] <= 5):
        with torch.serialization.safe_globals(_numpy_safe_globals()):
            return "torch", torch.load(path, map_location="cpu",
                                       weights_only=True)
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        from .flax_msgpack import read

        return "msgpack", read(path)
    raise ValueError(
        f"{path} is not a checkpoint the port reads (a port .pt, a JAX "
        "checkpoint.msgpack or orbax directory, or a reference or "
        "torchvision .pth/.pth.tar)")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a port ``.pt``, a JAX ``checkpoint.msgpack`` or orbax
    directory, or a reference ``.pth``/``.pth.tar`` (:func:`read_file`):
    ``{"state_dict"`` (CPU tensors keyed as the port's models),
    ``"reg_stats"`` (a numpy array, or None), ``"arch"``, ``"epoch"``,
    ``"best_loss"`` (inf where the file has none)``}``."""
    from ..models.convert import ssn_state_from_reference, state_dict_from_jax

    kind, raw = read_file(path)
    if kind == "torch":
        return ssn_state_from_reference(raw)
    rs = raw.get("reg_stats")
    return {"state_dict": state_dict_from_jax(raw["params"],
                                              raw.get("batch_stats") or {}),
            "reg_stats": None if rs is None else np.array(rs),
            "arch": raw.get("arch", ""),
            "epoch": int(raw.get("epoch", 0)),
            "best_loss": float(raw.get("best_loss", float("inf")))}
