"""In-place module assembly: K1 and K2 write an Inception module's branches
into channel slices of one buffer (``out=``), so the module's concat is a
view (``kernels.int8.channel_slots``, ``concat_channels``).

On the CPU the plain versions write into ``out`` as the kernels do on the
card, so the walks here are the ones the card runs: each int8 trunk built
in place equals the ``torch.cat`` walk and the JAX package bit for bit.
The kernels' own slice cases are in tests/test_torch_port_kernels_cuda.py
and tests/test_torch_port_step_graph.py (``cuda`` marker)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from action_detection_tpu.models.backbones import bn_inception_int8 as jbq
from action_detection_tpu.models.backbones import inception_v3_int8 as jiq

from action_detection_torch.kernels import (add_launch_counts, concat_counts,
                                            reset_launch_counts,
                                            tally_launches)
from action_detection_torch.kernels import int8 as k
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones import bn_inception_int8 as bq
from action_detection_torch.models.backbones import inception_v3_int8 as iq
from action_detection_torch.models.backbones.bn_inception import pool_pads
from action_detection_torch.models.convert import seeded_init

from tests.test_torch_port_int8 import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTINEL = {torch.int8: -77, torch.bfloat16: -3.5}

CONV_CASES = [  # (N, H, W, C, O, k, stride, pad)
    (2, 9, 9, 32, 24, 1, 1, 0),
    (2, 9, 9, 16, 40, 3, 1, 1),
    (2, 10, 11, 16, 12, 3, 2, 1),
    (1, 7, 7, 64, 48, 3, 2, 1),
]


def _conv_inputs(case):
    N, H, W, C, O, kk, stride, pad = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randint(0, 128, (N, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (O, kk, kk, C), generator=g,
                      dtype=torch.int8)
    m = torch.rand(O, generator=g) * 4.0 / (kk * kk * C * 64)
    b = torch.randn(O, generator=g) * 20
    return x, w, m, b


def _buffer(shape, channels, dtype):
    """A module buffer of ``channels`` filled with the sentinel."""
    return torch.full(tuple(shape) + (channels,), SENTINEL[dtype],
                      dtype=dtype)


def _assert_only_slice_written(buf, lo, hi, want):
    assert torch.equal(buf[..., lo:hi], want)
    assert (buf[..., :lo] == SENTINEL[buf.dtype]).all()
    assert (buf[..., hi:] == SENTINEL[buf.dtype]).all()


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
def test_conv_writes_into_a_channel_slice(case, out_dtype):
    """K1's wrapper (the plain version on the CPU) writes an output slice
    of a wider buffer; the bytes around it keep their sentinel and the
    values are the contiguous result's."""
    x, w, m, b = _conv_inputs(case)
    stride, pad = case[6], case[7]
    ref = k.int8_conv(x, w, m, b, stride, pad, out_dtype)
    O = ref.shape[-1]
    buf = _buffer(ref.shape[:3], 16 + O + 32, out_dtype)
    slot = buf[..., 16:16 + O]
    got = k.int8_conv(x, w, m, b, stride, pad, out_dtype, out=slot)
    assert got is slot
    _assert_only_slice_written(buf, 16, 16 + O, ref)
    assert torch.equal(k.int8_conv_plain(x, w, m, b, stride, pad, out_dtype),
                       ref)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
def test_entry_conv_splits_into_the_module_and_a_scratch(out_dtype):
    """The fused entry conv of inception_4a (1x1 224 | 3x3_reduce 64 |
    double_3x3_reduce 96, over 480 channels): its first 224 columns into
    the module's buffer at offset 0, the reduce heads into a tensor of
    their own, the values the unsplit output's."""
    x, w, m, b = _conv_inputs((1, 4, 5, 480, 384, 1, 1, 0))
    ref = k.int8_conv(x, w, m, b, out_dtype=out_dtype)
    buf = _buffer((1, 4, 5), 224 + 96 + 128 + 128, out_dtype)
    head = buf[..., :224]
    tail = torch.full((1, 4, 5, 160), SENTINEL[out_dtype], dtype=out_dtype)
    assert k.int8_out_refusal((head, tail)) is None
    got = k.int8_conv(x, w, m, b, out_dtype=out_dtype, out=(head, tail))
    assert got[0] is head and got[1] is tail
    _assert_only_slice_written(buf, 0, 224, ref[..., :224])
    assert torch.equal(tail, ref[..., 224:])


@pytest.mark.parametrize("shape,kw", [
    ((2, 9, 11, 32), dict(kernel=3, stride=2, ceil=True)),   # BNInception
    ((2, 35, 35, 48), dict(kernel=3, stride=2)),             # InceptionV3
    ((2, 9, 11, 96), dict(kernel=3, stride=1, pad=1))])
def test_max_pool_writes_into_a_channel_slice(shape, kw):
    """K2's wrapper (the plain version on the CPU) writes the passthrough
    branch into its slice of the module's buffer."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    args = (kw["kernel"], kw["stride"], pool_pads(*shape[1:3], **kw))
    ref = k.int8_max_pool(x, *args)
    C = shape[-1]
    buf = _buffer(ref.shape[:3], 64 + C + 16, torch.int8)
    slot = buf[..., 64:64 + C]
    assert k.int8_out_refusal(slot) is None
    assert k.int8_max_pool(x, *args, out=slot) is slot
    _assert_only_slice_written(buf, 64, 64 + C, ref)


def test_out_refusals_and_checks():
    """What the card refuses to write into (device-independent), and what
    no device takes."""
    buf = torch.zeros((2, 3, 4, 64), dtype=torch.int8)
    assert k.int8_out_refusal(buf) is None
    assert k.int8_out_refusal(buf[..., 16:40]) is None   # a 24-wide slice
    assert "aligned" in k.int8_out_refusal(buf[..., 8:24])
    assert "pixel stride" in k.int8_out_refusal(
        torch.zeros((2, 3, 4, 24), dtype=torch.int8)[..., :16])
    assert "pixel stride" in k.int8_out_refusal(buf[:, ::2, :, :16])
    assert "head" in k.int8_out_refusal((buf[..., :24], buf[..., 32:48]))
    bf = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16)
    assert k.int8_out_refusal((bf[..., :8], bf[..., 8:16])) is None

    x, w, m, b = _conv_inputs((2, 3, 4, 16, 32, 1, 1, 0))
    with pytest.raises(ValueError, match="cannot hold"):
        k.int8_conv(x, w, m, b, out=buf[:, :2, :, :32])
    with pytest.raises(ValueError, match="cannot hold"):
        k.int8_conv(x, w, m, b, out=buf[..., :32].float())
    with pytest.raises(ValueError, match="add up"):
        k.int8_conv(x, w, m, b, out=(buf[..., :16], buf[..., 16:48]))
    with pytest.raises(ValueError, match="cannot hold"):
        k.int8_max_pool(x, 3, 2, ((0, 1), (0, 1)), out=buf[..., :16])


def test_concat_is_a_view_only_of_adjacent_slices():
    """Handed the slots its parts were written into (adjacent slices of
    one module buffer, or a run of them: a nested concat), the concat is
    the slice they span; without slots it copies. Both counted."""
    reset_launch_counts()
    slots = k.channel_slots((2, 3, 3), [32, 16, 48], "cpu")
    for i, s in enumerate(slots):
        s.fill_(i + 1)
    whole = k.concat_channels(slots, slots)
    assert whole.is_contiguous() and whole.shape == (2, 3, 3, 96)
    assert whole.data_ptr() == slots[0].data_ptr()
    assert torch.equal(whole, torch.cat(slots, dim=-1))
    inner = k.concat_channels(slots[1:], slots[1:])   # a nested concat
    assert inner.shape == (2, 3, 3, 64) and not inner.is_contiguous()
    assert inner.data_ptr() == slots[1].data_ptr()
    assert torch.equal(inner, torch.cat(slots[1:], dim=-1))
    assert concat_counts() == {"concat_in_place": 2, "concat_copied": 0}
    # no slots (a face without module buffers, a module without one)
    for parts, no_slots in (([slots[1], slots[0]], None),
                            ([slots[0].clone(), slots[2]], [None, None])):
        got = k.concat_channels(parts, no_slots)
        assert torch.equal(got, torch.cat(parts, dim=-1))
        assert got.data_ptr() not in [p.data_ptr() for p in parts]
    assert concat_counts() == {"concat_in_place": 2, "concat_copied": 2}


def test_a_width_not_a_multiple_of_16_takes_the_counted_fallback():
    """A module whose branch widths are not all multiples of 16 gets no
    slots (a slice must start 16-byte aligned on the card): its branches
    write tensors of their own and its concat copies, counted."""
    assert k.channel_slots((1, 2, 2), [16, 24], "cpu") is None
    qe = {"a": {"wq": torch.zeros(32, 1, 1, 40, dtype=torch.int8)},
          "b": {"wq": torch.zeros(24, 3, 3, 40, dtype=torch.int8)}}
    x = torch.zeros((1, 5, 5, 40), dtype=torch.int8)
    for face in (bq._E2EOps(qe), iq._ForwardOps(qe)):
        assert face.module_slots(x, ["a", None], stride=2) == [None, None]
        assert face.module_slots(x, ["a", "b"]) == [None, None]
        slots = face.module_slots(x, ["a", "a"], stride=2)
        assert [tuple(s.shape) for s in slots] == [(1, 3, 3, 32)] * 2
        reset_launch_counts()
        parts = [torch.ones((1, 5, 5, 32), dtype=torch.int8),
                 torch.full((1, 5, 5, 24), 2, dtype=torch.int8)]
        got = face.concat(parts, face.module_slots(x, ["a", "b"]))
        assert torch.equal(got, torch.cat(parts, dim=-1))
        assert concat_counts() == {"concat_in_place": 0, "concat_copied": 1}


# --- both trunks, in place, against the torch.cat walk and JAX ------------


def _jax_tree(qe):
    """A port runtime tree -> the JAX package's layout (HWIO ``wq``); the
    stem is left out (the trunk does not read it)."""
    def conv(v):
        return {"wq": jnp.asarray(v["wq"].permute(1, 2, 3, 0).numpy()),
                "m": jnp.asarray(v["m"].numpy()),
                "bq": jnp.asarray(v["bq"].numpy())}

    out = {}
    for key, v in qe.items():
        if key == "__entry__":
            out[key] = {mod: conv(f) for mod, f in v.items()}
        elif isinstance(v, dict) and "wq" in v:
            out[key] = conv(v)
        elif key != "__stem__":
            out[key] = jnp.asarray(v.numpy())
    return out


class _IV3Acts(iq._ForwardOps):          # the last concat, before the mean
    def finish(self, y):
        return y


class _JIV3Acts(jiq._ForwardOps):
    def finish(self, y):
        return y


TRUNKS = {
    # arch: (crop, calibrate, stem, face, the walk's concats, JAX's face)
    "BNInception": (64, bq.calibrate_e2e, bq._e2e_stem_quantized, bq._E2EOps,
                    bq._walk_trunk, 10, jbq._E2EOps, jbq._walk_trunk),
    "InceptionV3": (75, iq.calibrate_e2e_iv3, iq._iv3_stem_quantized,
                    _IV3Acts, iq._walk_trunk, 15, _JIV3Acts,
                    jiq._walk_trunk),
}


@pytest.mark.parametrize("arch", sorted(TRUNKS))
def test_trunk_in_place_equals_cat_walk_and_jax(arch):
    """Each int8 trunk, its modules assembled in place (every concat a
    view), equals the walk whose concats copy and JAX's walk bit for bit,
    on a tree calibrated on the frames it scores."""
    crop, calibrate, stem, face, walk, n, jface, jwalk = TRUNKS[arch]
    model, _, _ = get_backbone(arch, "RGB")
    sd = seeded_init(model, seed=5).state_dict()
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.rand(2, crop, crop, 3) * 255.0 - 117.0)
                         .astype(np.float32))
    qe = calibrate(sd, x)
    h = stem(qe, x)

    class CatWalk(face):
        module_slots = bq._EntryDefault.module_slots

    reset_launch_counts()
    got = walk(face(qe), h)
    assert concat_counts() == {"concat_in_place": n, "concat_copied": 0}
    cat = walk(CatWalk(qe), h)
    assert concat_counts() == {"concat_in_place": n, "concat_copied": n}
    ref = np.asarray(jwalk(jface(_jax_tree(qe)), jnp.asarray(h.numpy())))
    assert got.is_contiguous() and got.shape == cat.shape == ref.shape
    assert (ref > 0).mean() > 0.1 and 0 < ref.max() <= 127   # not trivial
    np.testing.assert_array_equal(got.numpy(), cat.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)


def test_concat_counts_add_up_under_a_capture_tally():
    """A captured step's concats go to its thread's tally, not the
    counters; each replay adds the tally, as K1's launches."""
    model, _, _ = get_backbone("BNInception", "RGB")
    folded = bq.fold_bn(seeded_init(model, seed=0).state_dict())
    qe = bq.quantize_backbone_e2e(None, dict({n: 1.0 for n in folded},
                                             input=1.0), folded=folded)
    h = torch.randint(0, 128, (1, 4, 4, 192), dtype=torch.int8)
    reset_launch_counts()
    with tally_launches() as tally:
        bq._walk_trunk(bq._E2EOps(qe), h)
    assert tally == {"concat_in_place": 10}
    assert concat_counts()["concat_in_place"] == 0
    for _ in range(3):
        add_launch_counts(tally)
    assert concat_counts() == {"concat_in_place": 30, "concat_copied": 0}


# --- the benchmark's reader -------------------------------------------------


def _reader():
    path = os.path.join(ROOT, "portbench", "metrics",
                        "inplace_concat_share.score.py")
    spec = importlib.util.spec_from_file_location("inplace_concat_share",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _Run:
    def __init__(self, scorers):
        self.scorers = scorers


def test_inplace_concat_share_reader(monkeypatch):
    read = _reader()
    reset_launch_counts()
    assert read(_Run([object()])) is None           # no concat yet
    assert read(_Run([])) is None
    slots = k.channel_slots((1, 2, 2), [16, 32], "cpu")
    k.concat_channels(slots, slots)
    for _ in range(3):
        k.concat_channels([torch.zeros(1, 2, 2, 16, dtype=torch.int8)] * 2)
    assert read(_Run([object()])) == pytest.approx(25.0)
    assert read(_Run(None)) is None
    # a program without the counters (the parent of the in-place walks)
    import action_detection_torch.kernels as kernels

    monkeypatch.delattr(kernels, "concat_counts")
    assert read(_Run([object()])) is None
    reset_launch_counts()


def test_inplace_concat_share_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "inplace_concat_share.score"]
    assert entry == {"name": "inplace_concat_share.score", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "model step", "moves": "score_ticks_per_s",
                     "workloads": ["bni_thumos14.score_decoded"]}
    # appended after the 16 metrics it found (later ones follow it)
    assert bench["per_layer"].index(entry) == 16
    layers = {m["name"]: m["layer"] for m in bench["per_layer"]}
    assert layers["graph_replay_share.score"] == entry["layer"]
