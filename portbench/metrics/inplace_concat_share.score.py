"""Model step (``models/backbones/*_int8.py``, the int8 walks): the share
of the walks' concats (an Inception module's output; InceptionV3's nested
Mixed_7b/7c halves too) that cost nothing, their branches having written
one module buffer in place, ``100 * concat_in_place / (concat_in_place +
concat_copied)`` of the program's counters (``kernels.concat_counts()``),
in percent, over the process's scoring steps (the warm-up's included; a
replayed step counts its captured concats again); nothing where the
program keeps no such counters."""


def read(run):
    if not run.scorers:
        return None
    try:
        from action_detection_torch.kernels import concat_counts
    except ImportError:
        return None
    counts = concat_counts()
    done = counts["concat_in_place"] + counts["concat_copied"]
    if not done:
        return None
    return 100.0 * counts["concat_in_place"] / done
