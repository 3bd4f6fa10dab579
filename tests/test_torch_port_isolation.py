"""The port runs on a machine without jax, flax, yaml or PIL.

A subprocess blocks those four packages (``sys.modules[name] = None`` makes
any import of them raise), imports every module of action_detection_torch,
scores a synthetic video through the int8-e2e shared-stem ProposalScorer on
the CPU (plain kernels) for BNInception RGB (frames already at the scale
size), InceptionV3 RGB (frames resized by the numpy resize) and BNInception
and InceptionV3 Flow (10-channel stacks), resizes a THUMOS frame to
InceptionV3's scale size 341, and takes one BNInception SSN training step
(the max-pool backward on its plain version)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for blocked in ("jax", "jaxlib", "flax", "yaml", "PIL"):
        sys.modules[blocked] = None

    import importlib, os, pickle, pkgutil, tempfile
    import numpy as np
    import action_detection_torch

    names = [m.name for m in pkgutil.walk_packages(
        action_detection_torch.__path__, "action_detection_torch.")]
    for name in names:
        importlib.import_module(name)

    from action_detection_torch.config import get_configs
    from action_detection_torch.data.pipeline import (
        SyntheticFrameProvider, collect_calibration_frames)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.infer.scorer import (
        ProposalScorer, dump_scores_pickle, score_videos)
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.data.transforms import scale_frame
    from action_detection_torch.models.backbones import InputSpec

    big = scale_frame(np.zeros((256, 340, 3), np.uint8), 341)
    assert big.shape == (341, 452, 3), big.shape

    def score(pf, arch, modality, size, frame_wh):
        new_length = 1 if modality == "RGB" else 5
        ds = SSNDataset(pf, cfg.sampling, new_length=new_length,
                        test_interval=60)
        model = seeded_init(SSN(num_class=20, base_model=arch,
                                modality=modality, dropout=0.0), seed=0)
        base = model.input_spec
        spec = InputSpec(size, base.mean, base.std, base.bgr, base.div255)
        provider = SyntheticFrameProvider(width=frame_wh[0],
                                          height=frame_wh[1],
                                          modality=modality)
        calib = collect_calibration_frames(ds, provider, spec.input_size,
                                           spec.scale_size,
                                           new_length=new_length)
        factory = lambda dev: ProposalScorer(
            model, spec, reg_stats=np.array([[0.0, 0.0], [1.0, 1.0]]),
            num_class=20, chunk_frames=4, modality=modality, device=dev,
            quantize="e2e", calibration_frames=calib, shared_stem=True)
        res = score_videos(factory, ds, provider, device="cpu")
        out = os.path.join(d, "scores.pkl")
        dump_scores_pickle(res, out)
        with open(out, "rb") as f:
            return pickle.load(f)

    all_scores = []
    with tempfile.TemporaryDirectory() as d:
        pf = os.path.join(d, "props.txt")
        with open(pf, "w") as f:
            f.write("# 0\\nvideo_0\\n300\\n1\\n1\\n2 60 200\\n3\\n"
                    "2 0.8500 0.9000 50 210\\n2 0.2000 0.9000 90 150\\n"
                    "0 0.0000 0.0000 230 290\\n")
        cfg = get_configs("thumos14")
        # 97x73 frames are already at the 64^2 spec's scale size (73); the
        # 75^2 spec's (85) resizes them
        for arch, modality, size in (("BNInception", "RGB", 64),
                                     ("InceptionV3", "RGB", 75),
                                     ("BNInception", "Flow", 64),
                                     ("InceptionV3", "Flow", 75)):
            all_scores.append(score(pf, arch, modality, size, (97, 73)))
        provider = SyntheticFrameProvider(width=97, height=73)
        from action_detection_torch.data.pipeline import assemble_train_batch
        from action_detection_torch.data.transforms import (
            Compose, GroupCenterCrop, GroupRandomHorizontalFlip, GroupScale)
        from action_detection_torch.train import (
            batch_to_device, make_optimizer, make_train_step)
        tds = SSNDataset(pf, cfg.sampling, body_seg=1, aug_seg=1,
                         reg_stats=np.array([[0.0, 0.0], [1.0, 1.0]]))
        aug = Compose([GroupScale(73), GroupCenterCrop(64),
                       GroupRandomHorizontalFlip()])
        batch = assemble_train_batch(tds, [0], provider, aug,
                                     np.random.RandomState(0))
        tmodel = seeded_init(SSN(num_class=20, starting_segment=1,
                                 course_segment=1, ending_segment=1), seed=1)
        step = make_train_step(tmodel, make_optimizer(tmodel, 0.001, [3], 1),
                               cfg.sampling)
        met = step(batch_to_device(batch, "cpu"))
    assert all(np.isfinite(v.item()) for v in met.values()), met
    for scores in all_scores:
        rel, act, comp, reg = scores["video_0"]
        assert act.shape == (3, 21) and comp.shape == (3, 20)
        assert reg.shape == (3, 20, 2)
        assert all(np.isfinite(a).all() for a in (act, comp, reg))
    leaked = sorted(m for m in ("jax", "flax", "yaml", "PIL")
                    if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("ISOLATED-OK", len(names))
""")


def test_port_imports_and_scores_without_jax_flax_yaml_pil():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("ISOLATED-OK"), proc.stdout
    assert int(last.split()[1]) >= 25      # every module was imported
