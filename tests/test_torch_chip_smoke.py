"""The instruction counter behind ``chip_smoke.py``'s bounds, on a synthetic
``cuobjdump -sass`` listing (the script itself runs only on a card)."""

import pytest

import chip_smoke

# A grid-stride loop (head 0x20, back branch 0x120) as cuobjdump prints it: an
# if/else whose else side is the vector load, a slow path holding a nested loop,
# a loop exit, a predicated instruction, an empty forward branch.
LISTING = """
        Function : _ZN12_GLOBAL__N_111demo_kernelIfEEvPKfPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/               @P0 BRA 0x130 ;                           /* 0x0000000000000947 */
        /*0020*/                   IADD3 R0, R0, 0x1, RZ ;               /* 0x0000000100007810 */
        /*0030*/              @!P1 BRA P2, 0x70 ;                        /* 0x0000000000009947 */
        /*0040*/                   LDG.E R4, desc[UR4][R2.64] ;          /* 0x0000000402047981 */
        /*0050*/                   LDG.E R5, desc[UR4][R2.64+0x4] ;      /* 0x0000040402057981 */
        /*0060*/                   BRA 0x80 ;                            /* 0x0000000000007947 */
        /*0070*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0080*/              @!P3 BRA 0xd0 ;                            /* 0x000000000000b947 */
        /*0090*/                   LDG.E R9, desc[UR4][R10.64] ;         /* 0x000000040a097981 */
        /*00a0*/                   IADD3 R10, R10, 0x4, RZ ;             /* 0x000000040a0a7810 */
        /*00b0*/               @P4 BRA 0x90 ;                            /* 0x0000000000004947 */
        /*00c0*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*00d0*/                   FFMA R4, R4, R5, R6 ;                 /* 0x0000000504047223 */
        /*00e0*/               @P5 BRA 0x140 ;                           /* 0x0000000000005947 */
        /*00f0*/               @P6 FADD R7, R7, R4 ;                     /* 0x0000000407076221 */
        /*0100*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0110*/              @!P5 BRA 0x120 ;                           /* 0x000000000000d947 */
        /*0120*/              @!P0 BRA 0x20 ;                            /* 0x0000000000008947 */
        /*0130*/                   EXIT ;                                /* 0x000000000000794d */
        /*0140*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
"""


def test_sass_listing_parses_into_functions():
    funcs = chip_smoke.sass_functions(LISTING)
    (name, code), = funcs.items()
    assert name.startswith("_ZN12_GLOBAL__N_111demo_kernel")
    assert code[0] == (0x0, "LDC R1, c[0x0][0x28]") and code[-1] == (0x140, "EXIT")
    assert chip_smoke._branch("@!P1 BRA P2, 0x70") == (0x70, True)
    assert chip_smoke._branch("BRA 0x80") == (0x80, False)
    assert chip_smoke._branch("FFMA R4, R4, R5, R6") is None


def test_hot_loop_walks_the_vector_path_and_skips_slow_paths():
    """Head to back branch: IADD3, the if/else branch (taken: the vector side),
    LDG.E.128, the slow-path branch (taken: it skips a nested loop), FFMA, the
    loop exit (falls through), the predicated FADD, STG.E.128, the empty forward
    branch, the back branch: 10 instructions for 4 elements of one input array."""
    (code,) = chip_smoke.sass_functions(LISTING).values()
    assert chip_smoke.hot_loop_instructions(code, inputs=1) == pytest.approx(10 / 4)
    assert chip_smoke.hot_loop_instructions(code, inputs=2) == pytest.approx(10 / 2)
    # a kernel with no vectorised loop has no count
    assert chip_smoke.hot_loop_instructions(code[:3], inputs=1) is None


# A loop whose forward branches can skip work: a run-time branch over two
# multiplies (as a dropout flag), then a branch over an exit.
SKIPPING = """
        Function : _ZN12_GLOBAL__N_111skip_kernelIfEEvPKfPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/               @P0 BRA 0x50 ;                            /* 0x0000000000000947 */
        /*0030*/                   FMUL R4, R4, R4 ;                     /* 0x0000000404047220 */
        /*0040*/                   FMUL R5, R5, R5 ;                     /* 0x0000000505057220 */
        /*0050*/               @P1 BRA 0x70 ;                            /* 0x0000000000001947 */
        /*0060*/                   EXIT ;                                /* 0x000000000000794d */
        /*0070*/                   FADD R6, R4, R5 ;                     /* 0x0000000504067221 */
        /*0080*/              @!P2 BRA 0x10 ;                            /* 0x000000000000a947 */
        /*0090*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_hot_loop_count_is_a_lower_bound():
    """Head to back branch the fewest instructions run: the branch over the two
    multiplies skips them, and the way on from the second branch is past the exit:
    LDG.E.128, the first branch, the second branch, FADD, the back branch."""
    (code,) = chip_smoke.sass_functions(SKIPPING).values()
    assert chip_smoke.hot_loop_instructions(code, inputs=1) == pytest.approx(5 / 4)


@pytest.mark.parametrize("ins,is_float", [
    ("RED.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR4][R2.64], R5", True),
    ("ATOMG.E.ADD.F32.FTZ.RN.STRONG.GPU PT, R3, desc[UR4][R2.64], R5", True),
    ("ATOMS.ADD.F16x2.RN R3, [R2], R5", True),
    ("ATOMG.E.ADD.STRONG.GPU PT, R2, desc[UR8][R2.64], R7", False),
    ("RED.E.ADD.STRONG.GPU desc[UR4][R2.64], R5", False),
])
def test_float_atomics_are_told_from_integer_ones(ins, is_float):
    assert bool(chip_smoke.FLOAT_ATOMIC.search(ins)) == is_float


# The forward kernel of row 1 as three instances, without dropout, with it on the
# contiguous index map and with it on the striped map (template arguments): the same
# loop, the dropout one with two more instructions, the striped one with two more again.
FWD_INSTANCES = """
        Function : _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelIfLb0ELb0EEEvPKT_PS1_PKfS6_S6_S6_xiffffjjN6vaegan9StripeMapEi
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0030*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0040*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0050*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
        Function : _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelIfLb1ELb0EEEvPKT_PS1_PKfS6_S6_S6_xiffffjjN6vaegan9StripeMapEi
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   IMAD.HI.U32 R6, R4, 0x1, RZ ;         /* 0x0000000104067827 */
        /*0030*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0040*/                   FSEL R4, R4, RZ, P1 ;                 /* 0x000000ff04047208 */
        /*0050*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0060*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0070*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
        Function : _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelIfLb1ELb1EEEvPKT_PS1_PKfS6_S6_S6_xiffffjjN6vaegan9StripeMapEi
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   IMAD.HI.U32 R7, R5, R8, RZ ;          /* 0x0000000805077227 */
        /*0030*/                   IMAD R7, R7, R10, R11 ;               /* 0x0000000a07077224 */
        /*0040*/                   IMAD.HI.U32 R6, R4, 0x1, RZ ;         /* 0x0000000104067827 */
        /*0050*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0060*/                   FSEL R4, R4, RZ, P1 ;                 /* 0x000000ff04047208 */
        /*0070*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0080*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0090*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
"""


def test_each_dropout_instance_has_its_own_count(monkeypatch):
    """``kernel_counts`` keys each instance of row 1's forward on its dropout and
    index-map arguments, so a p = 0.5 site's SASS issue time reads the p = 0.5
    loop (6 instructions a pass of 4 elements), a p = 0 site's the p = 0 loop
    (4), and a p = 0.5 site on a stripe the striped loop (8). The bound itself
    is the larger of the bytes over the memory rate and the algorithm's
    operations (``fused.ops_per_element``) over the float32 rate."""
    from vaegan_tpu_torch.ops import fused

    import subprocess
    import torch

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=FWD_INSTANCES))
    counts, atomics = chip_smoke.kernel_counts({"bn_act_dropout": "lib.so"}, "cuobjdump")
    key = ("bn_act_dropout_fwd_kernel", "float32", None)
    assert counts == {key + (False, False, None): pytest.approx(4 / 4),
                      key + (True, False, None): pytest.approx(6 / 4),
                      key + (True, True, None): pytest.approx(8 / 4)}
    assert atomics == []
    bounds = chip_smoke.Bounds(bw=1e12, instr_rate=1e9, counts=counts)
    n = 1000
    for dropout, striped, per_element in ((False, False, 1.0), (True, False, 1.5),
                                          (True, True, 2.0)):
        ms, by, byte_ms, issue_ms, ops_ms = bounds(8, n, "bn_act_dropout_fwd_kernel",
                                                   torch.float32, None, dropout, striped)
        assert issue_ms == pytest.approx(per_element * n / 1e9 * 1e3)
        assert byte_ms == pytest.approx(8 / 1e12 * 1e3)
        assert ops_ms == pytest.approx(
            fused.ops_per_element("bn_act_dropout", 4, dropout) * n / chip_smoke.OPS_RATE * 1e3)
        assert by == "operations" and ms == max(byte_ms, ops_ms) == ops_ms


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117recon_sums_kernelIfEEvPKT_S3_PfPjS4_xi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117recon_sums_kernelIfEEvPKT_S3_PfPjS4_xi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 1032 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_PKfS7_S7_S7_xiffffjji' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_PKfS7_S7_S7_xiffffjji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_summary_names_each_kernel_by_its_instance():
    assert chip_smoke.ptxas_summary(PTXAS_REPORT) == [
        "recon_sums_kernel<f32>: Used 30 registers, used 1 barriers, 1032 bytes smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "bn_act_dropout_fwd_kernel<bf16, dropout>: Used 40 registers, used 1 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]


# Row 4's backward as a build with (striped, kl) template arguments compiles it: a
# bfloat16 instance whose pass reads 8 elements of each of its 3 arrays with one 16-byte
# load, a float32 one with two, and a bfloat16 loop of an earlier build (one template
# argument) with 8-byte loads of 4 elements.
BWD_INSTANCES = """
        Function : _ZN12_GLOBAL__N_118reparam_bwd_kernelI13__nv_bfloat16Lb1ELb0EEEvPKT_S4_S4_PKfPS2_S7_xjjxixx
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   LDG.E.128 R8, desc[UR4][R12.64] ;     /* 0x0000000402047981 */
        /*0030*/                   LDG.E.128 R16, desc[UR4][R14.64] ;    /* 0x0000000402047981 */
        /*0040*/                   IMAD.WIDE.U32 R20, R21, R22, RZ ;     /* 0x0000000402047981 */
        /*0050*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0060*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0070*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0080*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
        Function : _ZN12_GLOBAL__N_118reparam_bwd_kernelIfLb0ELb1EEEvPKT_S3_S3_PKfPS1_S6_xjjxixx
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   LDG.E.128 R8, desc[UR4][R2.64+0x10] ; /* 0x0000000402047981 */
        /*0030*/                   LDG.E.128 R12, desc[UR4][R6.64] ;     /* 0x0000000402047981 */
        /*0040*/                   LDG.E.128 R16, desc[UR4][R6.64+0x10] ; /* 0x0000000402047981 */
        /*0050*/                   LDG.E.128 R20, desc[UR4][R10.64] ;    /* 0x0000000402047981 */
        /*0060*/                   LDG.E.128 R24, desc[UR4][R10.64+0x10] ; /* 0x0000000402047981 */
        /*0070*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0080*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0090*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*00a0*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
        Function : _ZN12_GLOBAL__N_118reparam_bwd_kernelI13__nv_bfloat16Lb1EEEvPKT_S4_S4_PKfPS2_S7_xjjxixx
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.64 R4, desc[UR4][R2.64] ;       /* 0x0000000402047981 */
        /*0020*/                   LDG.E.64 R6, desc[UR4][R12.64] ;      /* 0x0000000402047981 */
        /*0030*/                   LDG.E.64 R8, desc[UR4][R14.64] ;      /* 0x0000000402047981 */
        /*0040*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0050*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0060*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
"""


@pytest.mark.parametrize("which,inputs,elem_bytes,per_element", [
    (0, 3, 2, 7 / 8),     # bf16, one 16-byte load an array: 8 elements a pass
    (1, 3, 4, 9 / 8),     # f32, two 16-byte loads an array: 8 elements
    (2, 3, 2, 5 / 4),     # bf16, one 8-byte load an array: 4 elements
    (1, 3, 2, 9 / 16),    # the f32 listing read as bf16: 16 elements
])
def test_hot_loop_elements_follow_load_width_and_dtype(which, inputs, elem_bytes, per_element):
    """Elements a pass are the path's wide-load bytes over the arrays read, at
    the element size: a 16-byte load is 4 float32 or 8 bfloat16 elements, an
    8-byte load 2 or 4."""
    code = list(chip_smoke.sass_functions(BWD_INSTANCES).values())[which]
    assert chip_smoke.hot_loop_instructions(code, inputs, elem_bytes) == pytest.approx(
        per_element)


def test_row4_instances_are_keyed_on_striped_and_kl(monkeypatch):
    """``kernel_counts`` keys row 4's instances on (striped, kl) and reads each
    one's elements from its dtype; ``Bounds`` finds the instance asked for, and
    for an earlier build whose row 4 has no kl argument it counts the one loop
    (kl None)."""
    import subprocess

    import torch

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=BWD_INSTANCES))
    counts, _ = chip_smoke.kernel_counts({"reparam_kl": "lib.so"}, "cuobjdump")
    k = "reparam_bwd_kernel"
    assert counts == {(k, "bfloat16", None, None, True, False): pytest.approx(7 / 8),
                      (k, "float32", None, None, False, True): pytest.approx(9 / 8),
                      (k, "bfloat16", None, None, True, None): pytest.approx(5 / 4)}
    bounds = chip_smoke.Bounds(bw=1e12, instr_rate=1e9, counts=counts)
    n = 8000
    issue = lambda **kw: bounds(10 * n, n, k, torch.bfloat16, striped=True, **kw)[3]  # noqa: E731
    assert issue(kl=False) == pytest.approx(7 / 8 * n / 1e9 * 1e3)
    assert issue(kl=True) == issue() == pytest.approx(5 / 4 * n / 1e9 * 1e3)
    assert bounds(20 * n, n, k, torch.float32, kl=True)[3] == pytest.approx(9 / 8 * n / 1e6)


def test_rotation_copies_keep_each_inputs_strides():
    """The timed inputs' copies keep the original's layout: row 5's one-channel
    (B, H, W, 1) images stay contiguous (a channels_last copy of one is not, and
    the wrapper would copy it inside every timed call), activations stay
    channels_last."""
    import torch

    img = torch.zeros(64, 512, 512, 1)                                         # 64 MB
    act = torch.zeros(2, 64, 256, 512).contiguous(memory_format=torch.channels_last)  # 64 MB
    rot = chip_smoke.rotation(img, act)
    assert len(rot) == 2 and rot[0][0] is img
    copy_img, copy_act = rot[1]
    assert copy_img.is_contiguous() and copy_img.stride() == img.stride()
    assert copy_act.is_contiguous(memory_format=torch.channels_last)
    assert copy_act.stride() == act.stride()


def test_loop_config_is_the_notebook_at_full_width(tmp_path):
    """Phase 8 trains the notebook preset uncut: 256², batch 4, float32, the
    full-width generator and critic, every kernel on, fed from the card."""
    import vaegan_tpu_torch as vt

    cfg = chip_smoke.loop_config(vt, str(tmp_path), max_steps=3)
    ref = vt.preset("notebook")
    assert cfg.generator == ref.generator and cfg.discriminator == ref.discriminator
    assert cfg.loss == ref.loss and cfg.optim == ref.optim
    assert (cfg.data.image_size, cfg.data.batch_size, cfg.train.dtype) == (256, 4, "float32")
    assert cfg.data.hbm_cache and cfg.data.synthetic_size == chip_smoke.LOOP_IMAGES
    t = cfg.train
    assert (t.use_pallas, t.n_epochs, t.sample_interval, t.checkpoint_every, t.log_every,
            t.nan_check, t.max_steps) == ("all", 2, 4, 4, 4, True, 3)
    assert t.sample_dir.startswith(str(tmp_path)) and t.checkpoint_dir.startswith(str(tmp_path))


def test_launch_logger_notes_each_steps_launches():
    """The launches between two ``log`` calls are the sampler's (before a grid
    step) and the step's."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.utils.metrics import MetricsLogger

    fused.reset_launches()
    logger = chip_smoke.launch_logger(fused, MetricsLogger)(sinks=[])
    for extra in (13, 0):
        fused.LAUNCHES["bn_act_dropout"] += 12 + extra
        fused.LAUNCHES["recon_loss_sums"] += 1
        logger.log(0, 1, 0, 2, {})
    fused.reset_launches()
    assert [s["bn_act_dropout"] for s in logger.per_step] == [25, 12]
    assert [s["recon_loss_sums"] for s in logger.per_step] == [1, 1]
    assert chip_smoke.SAMPLER_LAUNCHES["bn_act_dropout_bwd"] == 0


def test_state_trees_are_compared_bit_for_bit():
    from types import SimpleNamespace

    import torch

    state = SimpleNamespace(
        generator=torch.nn.Linear(2, 2), critic=torch.nn.Linear(2, 1),
        opt_g=torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=0.1),
        opt_d=torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=0.1),
        step=4, g_metrics={"g_loss": torch.tensor(1.0)}, g_ema=None)
    tree = chip_smoke.state_tree(torch, state)
    assert set(tree) == {"generator", "critic", "opt_g", "opt_d", "step", "g_metrics", "g_ema"}
    with torch.no_grad():
        state.generator.bias[0] += 1.0
    assert chip_smoke.tree_diff(torch, tree, chip_smoke.state_tree(torch, state)) == [
        ".generator.bias"]
    a = {"w": torch.ones(3), "opt": {"state": [{"step": torch.tensor(2.0)}], "lr": 3e-4}}
    c = {"w": torch.ones(3), "opt": {"state": [{"step": torch.tensor(2.0)}], "lr": 3e-4}}
    assert chip_smoke.tree_diff(torch, a, c) == []
    c["w"][1] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    c["opt"]["lr"] = 1e-3
    assert chip_smoke.tree_diff(torch, a, c) == [".w", ".opt.lr"]
    assert chip_smoke.metrics_close({"d": 1.0001, "g": 5.0}, {"d": 1.0, "g": 5.0}) == []
    assert chip_smoke.metrics_close({"d": 1.001, "g": 5.0}, {"d": 1.0, "g": 5.0}) == ["d"]


# ---------------------------------------------------------------- phase 9
def _counting(monkeypatch):
    """Count each kernel wrapper's calls on the CPU, where ``fused.LAUNCHES``
    counts nothing (a CPU tensor goes to the plain version)."""
    from vaegan_tpu_torch.ops import fused

    counts = dict.fromkeys(fused.LAUNCHES, 0)
    for name, fn in (("bn_act_dropout", "bn_act_dropout_forward"),
                     ("bn_act_dropout_bwd", "bn_act_dropout_backward"),
                     ("reparam_kl", "reparam_kl_forward"), ("reparam_kl_bwd", "reparam_kl_backward"),
                     ("recon_loss_sums", "recon_loss_sums_forward")):
        def wrapped(*a, _name=name, _orig=getattr(fused, fn), **k):
            counts[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(fused, fn, wrapped)
    return counts


@pytest.mark.parametrize("path", ["paper", "accum"])
def test_phase9_launch_counts_are_the_steps(monkeypatch, path):
    """The kernel calls of one step at the presets' full widths (at 32², on the
    CPU) are the counts phase 9 holds the card to: the paper step's
    (``PAPER_LAUNCHES``) and the notebook's grad_accum=2 G+D step's
    (``ACCUM_LAUNCHES``)."""
    import torch

    import vaegan_tpu_torch as vt

    torch.set_num_threads(1)
    name = "vaegan_paper" if path == "paper" else "notebook"
    cfg = vt.preset(name)
    cfg = cfg.replace(data=cfg.data.replace(image_size=32),
                      train=cfg.train.replace(use_pallas="all",
                                              grad_accum=2 if path == "accum" else 1))
    state = vt.create_train_state(cfg, device="cpu")
    step = vt.make_paper_train_step(cfg) if path == "paper" else vt.make_train_step(cfg, True)
    counts = _counting(monkeypatch)
    step(state, torch.rand(4 if path == "accum" else 2, 32, 32, 1), 3)
    want = chip_smoke.PAPER_LAUNCHES if path == "paper" else chip_smoke.ACCUM_LAUNCHES
    assert counts == want


def test_paper_config_and_critic_sites():
    """Phase 9 runs ``vaegan_paper`` uncut (96², batch 4, float32) with every
    kernel on, and its critic fuses 7 BN sites: the stem's and two per block."""
    import torch

    import vaegan_tpu_torch as vt

    cfg = chip_smoke.paper_config(vt)
    ref = vt.preset("vaegan_paper")
    assert cfg.replace(train=cfg.train.replace(use_pallas=ref.train.use_pallas)) == ref
    assert (cfg.data.image_size, cfg.data.batch_size, cfg.train.dtype,
            cfg.train.use_pallas) == (96, chip_smoke.TRAIN_BATCH, "float32", "all")
    _, critic = vt.build_models(cfg, device="cpu")
    assert critic.use_pallas
    assert chip_smoke.critic_sites(torch, critic, 96) == [
        (64, 96, 96), (64, 96, 96), (128, 96, 96), (128, 96, 96), (256, 48, 48),
        (256, 48, 48), (512, 24, 24)]


def test_paper_critic_draws_and_state_copies():
    """The injected critic masks cover each block's Dropout2d for the real and
    x_p forwards; a copied state has the state's modules and optimizer states,
    and shares no tensor with it."""
    import torch

    import vaegan_tpu_torch as vt

    cfg = chip_smoke.paper_config(vt)
    cfg = cfg.replace(data=cfg.data.replace(image_size=32))
    state = vt.create_train_state(cfg, device="cpu")
    rng = torch.Generator().manual_seed(0)
    inj = chip_smoke.critic_draws(torch, state.critic, 2, rng, "cpu", ("real", "prior"))
    inj["z_p"] = torch.randn((2,) + tuple(vt.latent_shape(cfg)), generator=rng)
    assert set(inj) == {"d_masks_real", "d_masks_prior", "alpha", "z_p"}
    assert {k: tuple(v.shape) for k, v in inj["d_masks_real"].items()} == {
        "res_layers.0.0.dropout": (2, 128, 1, 1), "res_layers.1.0.dropout": (2, 256, 1, 1),
        "res_layers.2.0.dropout": (2, 512, 1, 1)}
    assert tuple(inj["z_p"].shape) == (2, 8, 8, 256)
    vt.make_paper_train_step(cfg, inject=inj)(state, torch.rand(2, 32, 32, 1), 1)
    copy = chip_smoke.copy_state(torch, vt, cfg, state)
    a, b = chip_smoke.state_tree(torch, copy), chip_smoke.state_tree(torch, state)
    for part in ("generator", "critic", "opt_g", "opt_d"):
        assert chip_smoke.tree_diff(torch, a[part], b[part]) == [], part
    p = next(iter(state.opt_g.state.values()))["square_avg"]
    q = next(iter(copy.opt_g.state.values()))["square_avg"]
    assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()


def test_converge_spectral_reaches_each_weights_top_singular_value():
    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.models.layers import Conv2D

    cfg = chip_smoke.paper_config(vt)
    cfg = cfg.replace(data=cfg.data.replace(image_size=32),
                      discriminator=cfg.discriminator.replace(num_features_conv1=8,
                                                              num_features_res=(8, 16, 16)))
    _, critic = vt.build_models(cfg, device="cpu")
    chip_smoke.converge_spectral(torch, critic)
    for m in critic.modules():
        if isinstance(m, Conv2D) and m.spectral:
            w = m.weight_orig.detach().reshape(m.weight_orig.shape[0], -1)
            sigma = m.weight_u @ (w @ m.weight_v)
            assert float(sigma) == pytest.approx(float(torch.linalg.matrix_norm(w, 2)), rel=1e-4)


# ---------------------------------------------------------------- phase 10
@pytest.mark.parametrize("path", ["notebook-concat", "notebook-concat3", "paper-concat"])
def test_phase10_launch_counts_are_the_steps(monkeypatch, path):
    """The kernel calls of each step phase 10.1 counts on the card, at the
    presets' full widths (at 32², on the CPU): a notebook G+D and critic-only
    step under ``concat`` / ``concat3`` launch what a separate one does (the
    critic is unfused under the penalty); a ``concat`` paper step runs the
    critic's 7 fused sites once (``PAPER_CONCAT_LAUNCHES``)."""
    import torch

    import vaegan_tpu_torch as vt

    torch.set_num_threads(1)
    name, batching = path.split("-")
    cfg = chip_smoke.concat_config(vt, "vaegan_paper" if name == "paper" else "notebook",
                                   batching)
    cfg = cfg.replace(data=cfg.data.replace(image_size=32))
    state = vt.create_train_state(cfg, device="cpu")
    plan = (True,) if name == "paper" else (True, False)
    for do_g in plan:
        step = vt.make_paper_train_step(cfg) if name == "paper" else vt.make_train_step(cfg, do_g)
        counts = _counting(monkeypatch)
        step(state, torch.rand(2, 32, 32, 1), 3)
        monkeypatch.undo()
        want = chip_smoke.PAPER_CONCAT_LAUNCHES if name == "paper" else \
            chip_smoke.STEP_LAUNCHES[do_g]
        assert counts == want, do_g


def test_phase10_cli_train_launch_counts(monkeypatch, tmp_path, capsys):
    """``cli train`` as phase 10.2 runs it (the notebook preset from
    ``print-config`` with ``use_pallas`` "all", ``--synthetic``, 4 steps), at 32²
    on the CPU: the kernel calls are ``CLI_TRAIN_LAUNCHES`` (four G+D steps and
    the sampler's forward), and the counting wrapper runs the CLI."""
    import json

    import torch

    from vaegan_tpu_torch import cli

    torch.set_num_threads(1)
    assert cli.main(["print-config", "--preset", "notebook"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    cfg["train"]["use_pallas"] = "all"
    cfg["train"]["sample_dir"] = str(tmp_path / "samples")
    cfg["data"]["image_size"] = 32
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    counts = _counting(monkeypatch)
    assert cli.main(["train", "--config", str(tmp_path / "cfg.json"), "--synthetic",
                     "--max-steps", str(chip_smoke.CLI_STEPS), "--device", "cpu"]) == 0
    assert counts == chip_smoke.CLI_TRAIN_LAUNCHES
    assert "cli.main(sys.argv[1:])" in chip_smoke.CLI_COUNTING
    assert all(k in chip_smoke.CLI_TRAIN_LAUNCHES and v > 0
               for k, v in chip_smoke.CLI_TRAIN_LAUNCHES.items())


# ---------------------------------------------------------------- phase 11
def _dp_cpu_config(vt, tmp, **train):
    cfg = chip_smoke.dp_config(vt, str(tmp), 2, **train)
    return cfg.replace(data=cfg.data.replace(image_size=32))


def test_dp_config_is_the_preset_at_full_width(tmp_path):
    """Phase 11 runs ``vaegan_256_dp`` at the preset's widths, image size and
    dtype; only the schedule, the folders, ``use_pallas`` and ``remat`` are its
    own."""
    import vaegan_tpu_torch as vt

    ref = vt.preset("vaegan_256_dp")
    cfg = chip_smoke.dp_config(vt, str(tmp_path), 64)
    assert (cfg.generator, cfg.discriminator, cfg.loss, cfg.optim) == \
        (ref.generator, ref.discriminator, ref.loss, ref.optim)
    assert (cfg.data.image_size, cfg.data.batch_size, cfg.train.dtype, cfg.train.ema_decay) == \
        (256, 64, "bfloat16", 0.999) == (ref.data.image_size, ref.data.batch_size,
                                        ref.train.dtype, ref.train.ema_decay)
    assert (cfg.train.use_pallas, cfg.train.remat, cfg.train.n_critics) == ("all", True, 2)
    assert chip_smoke.DP_BATCHES[0] == ref.data.batch_size


def test_phase11_step_launch_counts(monkeypatch, tmp_path):
    """A remat G+D step of the DP preset reruns the generator's 12 fused sites
    in its backward; a critic-only step records no graph and reruns nothing
    (at 32², on the CPU)."""
    import torch

    import vaegan_tpu_torch as vt

    torch.set_num_threads(1)
    cfg = _dp_cpu_config(vt, tmp_path)
    state = vt.create_train_state(cfg, device="cpu")
    mesh = vt.parallel.make_mesh()
    for do_g in (True, False):
        counts = _counting(monkeypatch)
        vt.parallel.make_parallel_train_step(cfg, mesh, do_g)(state, torch.rand(2, 32, 32, 1), 3)
        monkeypatch.undo()
        assert counts == chip_smoke.DP_STEP_LAUNCHES[do_g], do_g


def test_phase11_loop_runs(monkeypatch, tmp_path):
    """Phase 11.1's three runs of ``train_data_parallel`` on the CPU (32²,
    batch 2): each step's kernel calls are ``DP_PLAN``'s, the resume to step 2
    restores the first run's state bit for bit, and the grids and checkpoints
    are where the phase looks for them."""
    import os
    import types

    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.utils.metrics import MetricsLogger

    torch.set_num_threads(1)
    cfg = _dp_cpu_config(vt, tmp_path)
    counts = _counting(monkeypatch)
    logger_class = chip_smoke.launch_logger(types.SimpleNamespace(LAUNCHES=counts),
                                            MetricsLogger)
    state, per_step, history, diff = chip_smoke.dp_loop(
        torch, vt, cfg, vt.parallel.make_mesh(), None,
        lambda **kw: logger_class(sinks=[], **kw), device="cpu")
    assert diff == []
    assert per_step == [chip_smoke.dp_step_launches(g, grid) for g, grid in chip_smoke.DP_PLAN]
    assert len(history) == 4 and state.step == 4
    assert sorted(os.listdir(cfg.train.sample_dir)) == ["0.png", "2.png"]
    assert vt.CheckpointManager(cfg.train.checkpoint_dir).all_steps() == [2, 4]


def test_phase11_cli_dp_launch_counts(monkeypatch, tmp_path, capsys):
    """``cli train --dp`` as phase 11.5 runs it (one process, the DP preset
    with ``n_critics`` 1 and one epoch of two batches), at 32² on the CPU
    (gloo): two remat G+D steps and the sampler's forward."""
    import json

    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch import cli

    torch.set_num_threads(1)
    cfg = _dp_cpu_config(vt, tmp_path, n_critics=1, n_epochs=1, checkpoint_dir=None)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    counts = _counting(monkeypatch)
    assert cli.main(["train", "--dp", "--config", str(tmp_path / "cfg.json"), "--max-steps",
                     str(chip_smoke.DP_CLI_STEPS), "--checkpoint", str(tmp_path / "ck"),
                     "--device", "cpu"]) == 0
    want = {k: chip_smoke.DP_CLI_STEPS * v + chip_smoke.SAMPLER_LAUNCHES[k]
            for k, v in chip_smoke.DP_STEP_LAUNCHES[True].items()}
    assert counts == want
    assert "done: 2 steps" in capsys.readouterr().out


def test_device_busy_is_the_union_of_kernel_intervals():
    """Two overlapping kernels and a later one: busy is the covered time, not
    the sum of the kernels' times; host events do not count."""
    import types

    DT = types.SimpleNamespace(CUDA="cuda", CPU="cpu")

    def ev(a, b, dev="cuda"):
        return types.SimpleNamespace(device_type=dev, time_range=types.SimpleNamespace(
            start=a, end=b))

    prof = types.SimpleNamespace(events=lambda: [ev(0, 1000), ev(500, 1500), ev(3000, 3500),
                                                 ev(0, 9000, "cpu"), ev(4000, 4000)])
    assert chip_smoke.device_busy_ms(prof, DT) == pytest.approx(2.0)


def test_phase11_ranks_held_state_and_statistics():
    """Phase 11.4's holds: a final state tensor within its tolerance reads at
    most 1, one element past it more, a counter that differs reads inf; a BN
    statistic is held against 1e-4 of its tensor's largest value + 1e-5."""
    import torch

    want = {"critic.c.weight_orig": torch.tensor([1.0, -2.0, 0.0]),
            "critic.c.weight_u": torch.tensor([0.5, 0.5]),
            "critic.bn.running_mean": torch.tensor([3.0]),
            "critic.bn.num_batches_tracked": torch.tensor(2),
            "g_ema.w": torch.tensor([4.0])}
    got = {k: v.clone() for k, v in want.items()}
    got["critic.c.weight_orig"] += torch.tensor([1e-4, 0.0, 0.0])
    got["critic.c.weight_u"] += 9e-4
    got["critic.bn.running_mean"] += 100.0             # left to held_bn
    errs = chip_smoke.held_state(got, want)
    assert "critic.bn.running_mean" not in errs
    assert errs["critic.c.weight_orig"] == pytest.approx(1e-4 / (1e-5 + 1e-4), rel=1e-3)
    assert errs["critic.c.weight_u"] == pytest.approx(0.9, rel=1e-3)
    assert errs["critic.bn.num_batches_tracked"] == 0.0 and errs["g_ema.w"] == 0.0
    got["critic.c.weight_orig"][2] = 1e-5 * 1.5
    got["critic.bn.num_batches_tracked"] += 1
    errs = chip_smoke.held_state(got, want)
    assert errs["critic.c.weight_orig"] == pytest.approx(1.5)
    assert errs["critic.bn.num_batches_tracked"] == float("inf")
    bn = chip_smoke.held_bn({"m": torch.tensor([10.0, 0.002])}, {"m": torch.tensor([10.0, 0.0])})
    assert bn["m"] == pytest.approx(0.002 / (1e-5 + 1e-3))


def test_step_errors_leave_out_a_net_that_was_not_updated():
    """A critic-only step records no generator gradients: the comparison holds
    the critic's and the metrics alone."""
    import torch

    rec = {"metrics": {"d_loss": 1.0, "g_loss": 2.0},
           "grads": {"d": {"w": torch.tensor([1.0, -1.0])}}}
    other = {"metrics": {"d_loss": 1.0, "g_loss": 2.0},
             "grads": {"d": {"w": torch.tensor([1.0, -1.001])}}}
    errs, bad = chip_smoke.step_errors(other, rec)
    assert set(errs) == {"d"} and not bad
    assert errs["d"][1] == pytest.approx(1e-3, rel=1e-3)
    assert chip_smoke.compare_steps("critic only", other, rec)
    rec["grads"]["g"] = {}
    assert set(chip_smoke.step_errors(other, rec)[0]) == {"d"}


# ---------------------------------------------------------------- phase 12
def test_tp_config_is_the_dp_config_with_a_model_axis(tmp_path):
    """Phases 12.3-12.4 run phase 11's configuration at batch ``TP_BATCH`` with
    ``parallel.num_model`` 2, and split exactly the notebook critic's
    ``linear_1``-``linear_3`` kernels (``linear_4`` has one output)."""
    import vaegan_tpu_torch as vt

    cfg = chip_smoke.tp_config(vt, str(tmp_path))
    ref = chip_smoke.dp_config(vt, str(tmp_path), chip_smoke.TP_BATCH)
    assert cfg.parallel.num_model == chip_smoke.MESH_MODEL == 2
    assert cfg.replace(parallel=ref.parallel) == ref
    assert chip_smoke.split_kernels(cfg) == ["linear_1.weight", "linear_2.weight",
                                             "linear_3.weight"]
    state = vt.create_train_state(cfg.replace(
        discriminator=cfg.discriminator.replace(linear_widths=(8, 4, 2)),
        data=cfg.data.replace(image_size=32)), device="cpu")
    assert [f"{n}.weight" for n, _ in vt.train.state.tp_linears(state.critic, 2)] == \
        chip_smoke.split_kernels(cfg)


def test_whole_from_slices_puts_split_tensors_back_in_model_order():
    import torch

    parts = [{"a.weight": torch.tensor([[1.0], [2.0]]), "b": torch.tensor([5.0])},
             {"a.weight": torch.tensor([[3.0], [4.0]]), "b": torch.tensor([5.0])}]
    whole = chip_smoke.whole_from_slices(torch, parts, {"a.weight"})
    assert whole["a.weight"].flatten().tolist() == [1.0, 2.0, 3.0, 4.0]
    assert whole["b"] is parts[0]["b"]


def test_phase12_stripe_part_is_the_global_tensors_part():
    """Phase 12.2 cuts rank (1, 1)'s rows and H stripe of each site of a
    batch-32 global tensor: rows 16-31, the lower half of H; its index map
    starts at the first element of row 16's lower half."""
    import torch

    from vaegan_tpu_torch.ops.replica import Replica

    rep = Replica(rank=1, world=2, model_rank=1, num_model=chip_smoke.MESH_MODEL, spatial=True)
    full = torch.arange(chip_smoke.STRIPE_BATCH * 3 * 4 * 2).view(chip_smoke.STRIPE_BATCH, 3,
                                                                 4, 2)
    part = rep.take(full, 2)
    assert part.shape == (16, 3, 2, 2) and torch.equal(part, full[16:, :, 2:])
    assert rep.index_map(part.shape) == ((16 * 4 + 2) * 2 * 3, 2 * 2 * 3, 4 * 2 * 3)


def test_timed_collectives_attribute_halos_gathers_and_sums(monkeypatch):
    """``timed_collectives`` books each all-reduce of a halo, of a gather and of
    a plain sum under its kind, in the forward and in the backward (whose
    cotangent sums run outside the wrapped methods), and undoes its patches."""
    import types

    import torch
    import torch.distributed as td

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.ops.replica import Replica

    shapes = []
    monkeypatch.setattr(td, "all_reduce", lambda t, *a, **k: shapes.append(tuple(t.shape)))
    card = types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda: None))
    spent = {}
    before = (td.all_reduce, Replica.gather, Replica.halo)
    undo = chip_smoke.timed_collectives(card, vt, spent)
    rep = Replica(num_model=2, model_group=object(), spatial=True)
    x = torch.rand((2, 3, 4, 5), requires_grad=True)
    h = torch.rand((2, 6), requires_grad=True)
    out = (rep.halo(x, 1, 1).sum() + rep.gather(h, 1).sum()
           + rep.all_reduce(h.sum(1), "model").sum())
    assert set(spent) == {"halo", "gather", "sum"} and len(shapes) == 3
    spent.clear()
    out.backward()
    assert set(spent) == {"halo", "gather", "sum"} and len(shapes) == 6
    undo()
    assert (td.all_reduce, Replica.gather, Replica.halo) == before
    spent.clear()
    rep.gather(h, 1)
    assert spent == {}


# ---------------------------------------------------------------- phase 14
@pytest.mark.parametrize("label", [r[0] for r in chip_smoke.HEADLINE_RUNS])
def test_phase14_headline_train_launch_counts(monkeypatch, tmp_path, capsys, label):
    """``reproduce_headline`` as phase 14.1 runs it (full widths, the kernels on,
    here at 32² and 2 steps on the CPU): the kernel calls of its ``train`` are
    ``journey_launches`` of the run's step (G+D steps and the sampler's
    forward), its JSON line carries the run's name, and the paper run reports
    its EMA draws (the preset keeps its 0.999)."""
    import json

    import torch

    from vaegan_tpu_torch.examples import reproduce_headline as rh

    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "JOURNEY_STEPS", 2)
    extra, per_step = next((e, p) for lab, e, p in chip_smoke.HEADLINE_RUNS if lab == label)
    counts = _counting(monkeypatch)
    seen = {}
    train = rh.train

    def counted(cfg, **kw):
        before = dict(counts)
        out = train(cfg, **kw)
        seen.update({k: counts[k] - before[k] for k in counts})
        return out

    monkeypatch.setattr(rh, "train", counted)
    rh.main(extra + ["--image-size", "32", "--dtype", "float32", "--use-pallas", "all",
                     "--max-steps", "2", "--draws", "1", "--out", str(tmp_path / "h"),
                     "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == chip_smoke.journey_launches(per_step)
    assert rec["run"] == label and rec["steps"] == 2
    assert ("eval_mse_repeat_draws_ema" in rec) == (label == "VAE-GAN-paper")
    assert "rh.main(sys.argv[1:])" in chip_smoke.HEADLINE_COUNTING


def test_phase14_closing_line_is_train_multichips(monkeypatch, tmp_path, capsys):
    """Phase 14.3 reads ``train_multichip``'s closing line with
    ``JOURNEY_CLOSING`` (one process on the CPU at a tiny width here)."""
    import torch

    from vaegan_tpu_torch.examples import train_multichip

    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)
    preset = train_multichip.preset
    monkeypatch.setattr(train_multichip, "preset", lambda name: preset(name).replace(
        generator=preset(name).generator.replace(depth=1, length=1, feature_size=8),
        discriminator=preset(name).discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(16, 16), pool_size=2, linear_widths=(16, 8, 8)),
        data=preset(name).data.replace(synthetic_size=16)))
    train_multichip.main(["--image-size", "16", "--batch-size", "4", "--max-steps", "2",
                          "--device", "cpu"])
    m = chip_smoke.JOURNEY_CLOSING.match(capsys.readouterr().out.strip().splitlines()[-1])
    assert m and m.groups()[:3] == ("2", "1", "1")
