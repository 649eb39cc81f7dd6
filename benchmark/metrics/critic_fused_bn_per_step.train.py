"""The critic's BN + LeakyReLU chains per step that run through rows 1-2
(``count("critic.fused_bn_act")`` in the critic's stem and blocks): seven a
forward at the notebook's widths, three forwards a step of Algorithm 1. A
program without the counter, or a critic built unfused, reads nothing."""

from harness import program_spans


def read(run):
    return program_spans.per_op(run, "train_loop",
                                lambda p, t0, t1: p.counts("critic.fused_bn_act", t0, t1) or None)
