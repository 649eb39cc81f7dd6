"""Command-line interface of the port (``vaegan_tpu/cli.py``'s subcommands, flags
and printed lines), run as ``python -m vaegan_tpu_torch.cli``:

    python -m vaegan_tpu_torch.cli train --preset notebook --data-dir nii
    python -m vaegan_tpu_torch.cli train --config cfg.json --synthetic --epochs 1
    torchrun --nproc_per_node=2 -m vaegan_tpu_torch.cli train --dp --config cfg.json
    python -m vaegan_tpu_torch.cli eval --checkpoint ckpt/ --preset vae_96 --data-dir nii
    python -m vaegan_tpu_torch.cli sample --checkpoint ckpt/ --preset notebook -n 25 -o out.png
    python -m vaegan_tpu_torch.cli interpolate --checkpoint ckpt/ ... -o interp.png
    python -m vaegan_tpu_torch.cli export --checkpoint ckpt/ --generator-out g.pt
    python -m vaegan_tpu_torch.cli import --generator g.pt --checkpoint ckpt/ --preset notebook
    python -m vaegan_tpu_torch.cli export-serving --checkpoint ckpt/ --out bundle/
    python -m vaegan_tpu_torch.cli search --trials 8 --results result/params.json
    python -m vaegan_tpu_torch.cli print-config --preset vaegan_paper
    python -m vaegan_tpu_torch.cli fetch-data --dest nii
    python -m vaegan_tpu_torch.cli bench [paper|vae|loop|infer|loader]

Every model command runs on ``--device`` (default ``cuda``; ``--device cpu``
runs on the CPU). Checkpoints are the port's ``<step>.pt`` files. ``export`` /
``import`` move ``state_dict``s in the reference notebook's key layout, which
the port's modules use themselves: ``export`` saves them, ``import`` loads them
strictly (``.pt`` or ``.npz``) and writes a checkpoint at step 0.
"""

from __future__ import annotations

import argparse
import sys

BENCH_MODES = ("paper", "vae", "loop", "infer", "loader", "roofline")


def _load_cfg(args):
    from vaegan_tpu_torch.config import Config, preset

    cfg = Config.from_json(args.config) if getattr(args, "config", None) else preset(args.preset)
    d = cfg.data
    if getattr(args, "data_dir", None):
        d = d.replace(root_dir=args.data_dir)
    if getattr(args, "synthetic", False):
        d = d.replace(synthetic=True)
    if getattr(args, "synthetic_style", None):
        d = d.replace(synthetic_style=args.synthetic_style)
    if getattr(args, "hbm_cache", False):
        d = d.replace(hbm_cache=True)
    if getattr(args, "batch_size", None):
        d = d.replace(batch_size=args.batch_size)
    if getattr(args, "image_size", None):
        d = d.replace(image_size=args.image_size)
    cfg = cfg.replace(data=d)
    t = cfg.train
    if getattr(args, "epochs", None) is not None:
        t = t.replace(n_epochs=args.epochs)
    if getattr(args, "checkpoint", None):
        t = t.replace(checkpoint_dir=args.checkpoint)
    if getattr(args, "seed", None) is not None:
        t = t.replace(seed=args.seed)
    if getattr(args, "grad_accum", None) is not None:
        if args.grad_accum < 1:
            raise SystemExit(f"--grad-accum must be >= 1, got {args.grad_accum}")
        t = t.replace(grad_accum=args.grad_accum)
    if getattr(args, "ema_decay", None) is not None:
        t = t.replace(ema_decay=args.ema_decay)
    if getattr(args, "gp_every", None) is not None:
        t = t.replace(gp_every=args.gp_every)
    if getattr(args, "max_steps", None) is not None:
        # 0 = unbounded, overriding any budget in the loaded config
        t = t.replace(max_steps=args.max_steps or None)
    return cfg.replace(train=t)


def _restore(cfg, ckpt_dir, device):
    """The latest checkpoint under ``ckpt_dir``, restored into a template whose
    generator EMA matches what the checkpoint carries (the decay's value does not
    matter at inference), whatever the flags and config say."""
    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.train import create_train_state

    mgr = CheckpointManager(ckpt_dir)
    t = cfg.train
    saved = mgr.saved_has_g_ema()
    if saved is True:
        tmpl_cfg = cfg if t.ema_decay is not None else cfg.replace(
            train=t.replace(ema_decay=0.999))
    elif saved is False:
        tmpl_cfg = cfg if t.ema_decay is None else cfg.replace(train=t.replace(ema_decay=None))
    else:  # unreadable metadata: trust the current flags
        tmpl_cfg = cfg
    state = mgr.restore(create_train_state(tmpl_cfg, device=device, seed=t.seed))
    mgr.close()
    return state


def _generator_state(args, cfg):
    """The checkpoint's generator as a ``GeneratorState`` (its EMA iterate with
    ``--ema``)."""
    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.train import GeneratorState

    state = _restore(cfg, args.checkpoint, args.device)
    gen = GeneratorState(generator=state.generator, ema=state.g_ema, step=state.step)
    return inference.with_ema(gen) if getattr(args, "ema", False) else gen


def cmd_train(args):
    from vaegan_tpu_torch.train.loop import train
    from vaegan_tpu_torch.utils.metrics import JsonlSink, MetricsLogger, StdoutSink

    cfg = _load_cfg(args)
    if args.dp:
        # one process per device under torchrun; the sinks are rank 0's
        from vaegan_tpu_torch.parallel import dist
        from vaegan_tpu_torch.parallel.train import train_data_parallel

        device = dist.initialize(device=args.device)
        lead = dist.rank() == 0
    else:
        lead = True
    sinks = [StdoutSink()] if lead else []
    if args.metrics_jsonl and lead:
        sinks.append(JsonlSink(args.metrics_jsonl))
    logger = MetricsLogger(sinks=sinks, flush_every=cfg.train.log_every)
    if args.dp:
        try:
            state, logger = train_data_parallel(cfg, logger=logger, resume=args.resume,
                                                device=device)
        finally:
            dist.shutdown()
    else:
        state, logger = train(cfg, logger=logger, resume=args.resume, device=args.device)
    logger.close()
    print(f"done: {sum(1 for m in logger.history if '_wall_s' not in m)} steps")
    return 0


def cmd_export_serving(args):
    """Checkpoint -> self-contained serving bundle (``torch.export`` programs)."""
    from vaegan_tpu_torch import serving

    cfg = _load_cfg(args)
    gen = _generator_state(args, cfg)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    mpath = serving.save_bundle(args.out, cfg, gen, image_size=getattr(args, "image_size", None),
                                platforms=platforms, batch_size=args.batch or None)
    print(f"serving bundle ({', '.join(platforms)}; batch "
          f"{'symbolic' if not args.batch else args.batch}) -> {mpath}")
    return 0


def cmd_eval(args):
    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.data.pipeline import make_loader

    cfg = _load_cfg(args)
    gen = _generator_state(args, cfg)
    if args.recalibrate_bn:
        gen = inference.recalibrate_bn_stats(
            cfg, gen, make_loader(cfg.data, seed=cfg.train.seed + 1, device=args.device),
            num_batches=args.recalibrate_bn)
    loader = make_loader(cfg.data, seed=cfg.train.seed, device=args.device)
    mse = inference.evaluate_mse(cfg, gen, iter(loader), num_batches=args.num_batches)
    print(f"Mean squared error between original and reconstructed images: {mse:.4f}")
    return 0


def _cpu_state_dict(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def cmd_export(args):
    import torch

    cfg = _load_cfg(args)
    state = _restore(cfg, args.checkpoint, args.device)
    gen_sd, disc_sd = _cpu_state_dict(state.generator), _cpu_state_dict(state.critic)
    torch.save(gen_sd, args.generator_out)
    torch.save(disc_sd, args.discriminator_out)
    print(f"exported generator ({len(gen_sd)} tensors) -> {args.generator_out}, "
          f"discriminator ({len(disc_sd)} tensors) -> {args.discriminator_out}")
    return 0


def _load_state_dict(path):
    import numpy as np
    import torch

    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_strict(module, sd, what, path):
    try:
        module.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise ValueError(f"the {what} state_dict in {path} does not match the configured "
                         f"architecture: {e}") from e


def cmd_import(args):
    """Notebook-layout state_dicts -> a port checkpoint at step 0 (the inverse of
    ``export``)."""
    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.train import create_train_state

    cfg = _load_cfg(args)
    gen_sd = _load_state_dict(args.generator)
    disc_sd = _load_state_dict(args.discriminator) if args.discriminator else None
    state = create_train_state(cfg, device=args.device, seed=cfg.train.seed)
    _load_strict(state.generator, gen_sd, "generator", args.generator)
    if disc_sd is not None:
        _load_strict(state.critic, disc_sd, "discriminator", args.discriminator)
    if state.g_ema is not None:      # the EMA starts from the imported weights
        state.g_ema = {k: p.detach().clone() for k, p in state.generator.named_parameters()}
    mgr = CheckpointManager(args.checkpoint)
    mgr.save(state, force=True)
    mgr.wait()
    mgr.close()
    critic = (f"critic from {args.discriminator}" if args.discriminator
              else "fresh-initialized critic")
    print(f"imported generator from {args.generator} ({len(gen_sd)} tensors), "
          f"{critic} -> checkpoint at {args.checkpoint} (step 0)")
    return 0


def cmd_sample(args):
    import torch

    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.utils.imaging import save_image_grid

    cfg = _load_cfg(args)
    gen = _generator_state(args, cfg)
    dev = next(gen.generator.parameters()).device
    rng = torch.Generator(device=dev).manual_seed(args.seed or 0)
    imgs = inference.sample(cfg, gen, rng, n=args.num)
    save_image_grid(imgs, args.output, nrow=5)
    print(f"wrote {args.num} prior samples to {args.output}")
    return 0


def cmd_interpolate(args):
    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.data.pipeline import make_loader
    from vaegan_tpu_torch.utils.imaging import save_image_grid

    cfg = _load_cfg(args)
    gen = _generator_state(args, cfg)
    batch = next(iter(make_loader(cfg.data, seed=cfg.train.seed, device=args.device)))
    seq = inference.interpolate(cfg, gen, batch[:1], batch[1:2], steps=args.steps)
    save_image_grid(seq[:, 0], args.output, nrow=args.steps)
    print(f"wrote {args.steps}-step interpolation to {args.output}")
    return 0


def cmd_print_config(args):
    print(_load_cfg(args).to_json())
    return 0


def cmd_search(args):
    from vaegan_tpu_torch.search import random_search

    random_search(_load_cfg(args), n_trials=args.trials, results_path=args.results,
                  archive_dir=args.archive, seed=args.seed or 0,
                  max_steps_per_trial=args.max_steps_per_trial or None, device=args.device)
    return 0


def cmd_fetch_data(args):
    from vaegan_tpu_torch.data.fetch import REFERENCE_DATASET_URL, fetch_dataset

    n = fetch_dataset(url=args.url or REFERENCE_DATASET_URL, dest=args.dest,
                      archive_path=args.archive)
    print(f"extracted {n} NIfTI files into {args.dest}")
    return 0


def cmd_bench(args):
    # bare words (argparse rejects unknown --flags): `bench loader`
    modes = [m.lstrip("-") for m in (args.mode or [])]
    bad = [m for m in modes if m not in BENCH_MODES]
    if bad:
        print(f"unknown bench mode(s) {bad}; valid: {sorted(BENCH_MODES)}", file=sys.stderr)
        return 2
    # one mode, or roofline with a step selector (`bench roofline paper`
    # attributes the Larsen step), as the JAX CLI takes them
    combo = "roofline" in modes and len(modes) == 2 and set(modes) - {"roofline"} <= {
        "paper", "vae"}
    if len(modes) > 1 and not combo:
        print(f"pass at most one bench mode (or 'roofline' plus 'paper'|'vae'), got {modes}",
              file=sys.stderr)
        return 2
    from vaegan_tpu_torch import bench

    return bench.main([f"--{m}" for m in modes] + ["--device", args.device])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vaegan_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, ckpt_required=False):
        sp.add_argument("--preset", default="notebook")
        sp.add_argument("--config", help="JSON config file (overrides --preset)")
        sp.add_argument("--data-dir")
        sp.add_argument("--synthetic", action="store_true")
        sp.add_argument("--synthetic-style", choices=["blobs", "edges", "texture"],
                        help="synthetic-data style (data.pipeline.SyntheticDataset)")
        sp.add_argument("--batch-size", type=int)
        sp.add_argument("--image-size", type=int)
        sp.add_argument("--seed", type=int)
        sp.add_argument("--checkpoint", required=ckpt_required, help="checkpoint directory")
        device(sp)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the CPU)")

    sp = sub.add_parser("train", help="run training")
    common(sp)
    sp.add_argument("--epochs", type=int)
    sp.add_argument("--metrics-jsonl", help="write metrics to this JSONL file")
    sp.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint and continue")
    sp.add_argument("--dp", action="store_true",
                    help="data-parallel training over the processes torchrun starts, one "
                         "per device (torchrun --nproc_per_node=N -m vaegan_tpu_torch.cli "
                         "train --dp ...); NCCL on cuda (gloo where processes share a "
                         "card), gloo on cpu; the mesh is parallel.num_data x "
                         "parallel.num_model of the config (num_model > 1 splits the "
                         "critic head over the model axis)")
    sp.add_argument("--ema-decay", type=float,
                    help="maintain a generator-param EMA at this decay (e.g. 0.999); "
                         "evaluate it with --ema")
    sp.add_argument("--gp-every", type=int,
                    help="lazy gradient penalty: the WGAN-GP term every k-th step with "
                         "lambda_gp scaled by k (1 = every step, the reference's)")
    sp.add_argument("--grad-accum", type=int,
                    help="microbatch accumulation factor >= 1 (one optimizer update per "
                         "accumulated batch)")
    sp.add_argument("--hbm-cache", action="store_true",
                    help="stage the whole decoded dataset in device memory and gather "
                         "batches there (no per-step host-to-device copy; one process)")
    sp.add_argument("--max-steps", type=int,
                    help="hard optimizer-step budget; 0 = unbounded (overrides the config)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("export", help="save a checkpoint's generator and critic as "
                                       "state_dicts in the reference notebook's layout")
    common(sp, ckpt_required=True)
    sp.add_argument("--generator-out", default="generator_state_dict.pt")
    sp.add_argument("--discriminator-out", default="discriminator_state_dict.pt")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("import", help="import reference-notebook state_dicts (.pt or .npz) "
                                       "as a checkpoint")
    common(sp, ckpt_required=True)
    sp.add_argument("--generator", required=True,
                    help="UnsupervisedGeneratorNetwork.state_dict() file")
    sp.add_argument("--discriminator",
                    help="Discriminator.state_dict() file (optional; the reference's "
                         "experiment() only returns the generator)")
    sp.set_defaults(fn=cmd_import)

    sp = sub.add_parser(
        "export-serving",
        help="export a checkpoint as a self-contained serving bundle (reconstruct/encode/"
             "decode as torch.export programs; loads with torch alone, no model code)")
    common(sp, ckpt_required=True)
    sp.add_argument("--out", default="serving_bundle", help="output bundle directory")
    sp.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated devices the bundle may be loaded on (default cpu,cuda)")
    sp.add_argument("--batch", type=int, default=0,
                    help="pin the batch dimension (default 0 = symbolic: one program serves "
                         "any batch size)")
    sp.add_argument("--ema", action="store_true", help="export the generator-EMA iterate")
    sp.set_defaults(fn=cmd_export_serving)

    ema_help = "evaluate the generator-EMA iterate (requires a checkpoint trained with ema_decay)"
    sp = sub.add_parser("eval", help="reconstruction MSE on data batches")
    common(sp, ckpt_required=True)
    sp.add_argument("--ema", action="store_true", help=ema_help)
    sp.add_argument("--num-batches", type=int, default=1)
    sp.add_argument("--recalibrate-bn", type=int, default=0, metavar="N",
                    help="re-estimate the generator's BN running stats from N data batches "
                         "before evaluating (inference.recalibrate_bn_stats)")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("sample", help="decode prior samples")
    common(sp, ckpt_required=True)
    sp.add_argument("--ema", action="store_true", help=ema_help)
    sp.add_argument("-n", "--num", type=int, default=25)
    sp.add_argument("-o", "--output", default="samples.png")
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("interpolate", help="latent interpolation between two images")
    common(sp, ckpt_required=True)
    sp.add_argument("--ema", action="store_true", help=ema_help)
    sp.add_argument("--steps", type=int, default=8)
    sp.add_argument("-o", "--output", default="interpolation.png")
    sp.set_defaults(fn=cmd_interpolate)

    sp = sub.add_parser("search", help="hyperparameter random search")
    common(sp)
    sp.add_argument("--trials", type=int, default=8)
    sp.add_argument("--results", default="result/params.json")
    sp.add_argument("--archive", default="result/archive")
    sp.add_argument("--max-steps-per-trial", type=int, default=200,
                    help="per-trial optimizer-step cap; 0 = uncapped (full n_epochs per "
                         "trial, like the reference)")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("print-config", help="dump the resolved config JSON")
    common(sp)
    sp.set_defaults(fn=cmd_print_config)

    sp = sub.add_parser("fetch-data", help="download + extract the reference's hand X-ray "
                                           "dataset (or any NIfTI zip) into a flat dir")
    sp.add_argument("--dest", default="nii", help="output directory (default nii)")
    sp.add_argument("--url", help="zip URL (default: the reference's Drive link)")
    sp.add_argument("--archive", help="already-downloaded zip (skips the download)")
    sp.set_defaults(fn=cmd_fetch_data)

    sp = sub.add_parser("bench", help="run the port's throughput benchmark "
                                      "(python -m vaegan_tpu_torch.bench)")
    sp.add_argument("mode", nargs="*",
                    help="bench mode: paper | vae | loop | infer | loader | roofline "
                         "(default: the notebook WGAN-GP step); 'roofline paper' / "
                         "'roofline vae' attribute those steps instead")
    device(sp)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
