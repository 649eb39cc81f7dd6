"""The user journeys of the port, each the counterpart of the JAX package's
script of the same name in ``examples/`` (the same flags, defaults and printed
lines, plus ``--device``):

    python -m vaegan_tpu_torch.examples.reproduce_headline [--vae] [--device cpu]
    python -m vaegan_tpu_torch.examples.train_vaegan [--device cpu]
    python -m vaegan_tpu_torch.examples.train_multichip [--virtual N] [--device cpu]

Each module builds its ``Config`` in ``build_config(args)`` and runs in
``main(argv=None)``.
"""
