"""Pretrained-weight initialization for the training CLIs.

Port of ``action_detection_tpu/train/init_weights.py``, with the same
precedence: ``--init_weights`` file > ``--kinetics_pretrain`` (the dataset
config's URL, looked up in the local cache) > Flow's flow-init URL (cache;
an uncached file warns and keeps the seeded init) > the seeded init with
the JAX CLI's loud warning. Nothing is downloaded.

``--init_weights`` takes a port ``.pt`` checkpoint (its ``base_model.*``
weights and running statistics are grafted), a reference or torchvision
backbone ``.pth``/``.pth.tar`` state dict (``module.``/``base_model.``
stripped, ``models/convert.py:backbone_state_from_reference``; keys the
backbone does not have, such as an ImageNet dump's ``fc.*`` or VGG's
``classifier.6.*``, are left out) or a JAX ``checkpoint.msgpack`` (its
``backbone`` trees, ``models/convert.py:state_dict_from_jax``); the format
is read from the file's first bytes. A first conv whose input channels
differ (an RGB backbone into a Flow or an RGBDiff model: 10 or 15
channels) is converted by ``cross_modality_init``. Every backbone weight
must be in the file.
"""

from __future__ import annotations

import os

from torch import nn

from ..config import DatasetConfig, resolve_pretrained_init
from ..models.convert import (backbone_state_from_reference,
                              cross_modality_init, state_dict_from_jax)
from .checkpoint import read_file


def first_conv_name(backbone: nn.Module) -> str:
    """The name of the backbone's first convolution (registration order)."""
    return next(n for n, m in backbone.named_modules()
                if isinstance(m, nn.Conv2d))


def backbone_state(path: str) -> dict:
    """The backbone weights and running statistics of the checkpoint at
    ``path``, keyed by the port's backbone names."""
    kind, raw = read_file(path)
    if kind == "torch":
        return backbone_state_from_reference(raw.get("state_dict", raw))
    params, stats = raw["params"], raw.get("batch_stats") or {}
    return state_dict_from_jax(params.get("backbone", params),
                               stats.get("backbone", stats))


def load_backbone_weights(model: nn.Module, path: str) -> None:
    """Graft the backbone of the checkpoint at ``path`` onto
    ``model.base_model`` (weights and running statistics; the model's own
    ``num_batches_tracked`` stay). Raises ``ValueError`` naming the missing
    keys when the file lacks any backbone weight."""
    sd = backbone_state(path)
    backbone = model.base_model
    own = backbone.state_dict()
    key = first_conv_name(backbone) + ".weight"
    if key in sd and sd[key].shape[1] != own[key].shape[1]:
        have, want = sd[key].shape[1], own[key].shape[1]
        sd[key] = cross_modality_init(sd[key], want)
        print(f"=> cross-modality first conv: {have} -> {want} channels")
    wanted = [k for k in own if not k.endswith("num_batches_tracked")]
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise ValueError(f"{path}: {len(missing)} backbone weights missing, "
                         f"e.g. {missing[:5]}")
    backbone.load_state_dict({k: sd[k] for k in wanted}, strict=False)


def apply_init_weights(model: nn.Module, args, cfg: DatasetConfig) -> None:
    """The reference's init policy on ``model`` (in place); ``args`` has
    ``init_weights``, ``kinetics_pretrain``, ``arch`` and ``modality``."""
    if args.init_weights:
        if not os.path.isfile(args.init_weights):
            print(f"=> no weights file found at '{args.init_weights}'")
            return
        load_backbone_weights(model, args.init_weights)
        print(f"=> loaded init weights from '{args.init_weights}'")
        return

    kinetics = bool(args.kinetics_pretrain)
    if kinetics:
        # asked for explicitly: an unknown arch or an uncached file raises
        path = resolve_pretrained_init(cfg, args.arch, args.modality,
                                       kinetics=True)
    elif args.modality == "Flow":
        try:
            path = resolve_pretrained_init(cfg, args.arch, args.modality)
        except KeyError:
            print(f"=> no flow_init URL for arch {args.arch}; using the "
                  f"seeded init")
            path = None
        except FileNotFoundError as e:
            print(f"=> WARNING: flow init checkpoint not cached; training "
                  f"from the seeded init (the reference would download "
                  f"it):\n{e}")
            path = None
    else:
        print("=> WARNING: no pretrained backbone init. The reference starts "
              "RGB training from ImageNet-pretrained weights; pass "
              "--init_weights <imagenet .pth dump> or --kinetics_pretrain "
              "for a comparable run (fine for synthetic smoke tests).")
        path = None
    if path is not None:
        load_backbone_weights(model, path)
        print(f"=> loaded {'kinetics' if kinetics else 'flow'} init "
              f"weights from '{path}'")
