"""The research tools of the port, each the counterpart of the JAX package's
script of the same name in ``tools/`` (the same flags, defaults, printed JSON
keys and output files, plus ``--device``, default ``cuda``: a tool raises
without a card and runs on the CPU only with ``--device cpu``):

    python -m vaegan_tpu_torch.tools.make_nifti_dataset --out nii_blobs [--style blobs]
    python -m vaegan_tpu_torch.tools.paper_probe [--data-dir nii_blobs] [--keep-best]
    python -m vaegan_tpu_torch.tools.gan_only_budget [--keep-best] [--steps 20000]
    python -m vaegan_tpu_torch.tools.large_batch_recipe [--grad-accum 4] [--ema-decay 0.999]
    python -m vaegan_tpu_torch.tools.edges_multiseed [--seeds 4] [--data-dir nii_blobs]
    python -m vaegan_tpu_torch.tools.profile_step_residual [--vae|--paper] [--critic-only]
    python -m vaegan_tpu_torch.tools.conv_fusion_evidence [--hlo ops.txt]
    python -m vaegan_tpu_torch.tools.paper_loss_fusion_evidence [--pallas]
    python -m vaegan_tpu_torch.tools.run_256dp_virtual_mesh [--devices 8]

The tools that train also take ``--use-pallas {off,losses,all}`` (the fused
CUDA kernels), whose default is the preset's value, so that without it the
config is the JAX script's. The modules that build a ``Config`` do so in
``build_config(args)``; each runs in ``main(argv=None)``. Config 3's and
config 2's recipes are ``paper_probe --keep-best`` and ``gan_only_budget
--keep-best``: the best iterate, kept on the card, is the run's deliverable.
"""
