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


# The forward kernel of row 1 as two instances, without and with dropout (a
# template argument): the same loop, the dropout one with two more instructions.
FWD_INSTANCES = """
        Function : _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelIfLb0EEEvPKT_PS1_PKfS6_S6_S6_xiffffjji
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0030*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0040*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0050*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
        Function : _ZN12_GLOBAL__N_125bn_act_dropout_fwd_kernelIfLb1EEEvPKT_PS1_PKfS6_S6_S6_xiffffjji
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0020*/                   IMAD.HI.U32 R6, R4, 0x1, RZ ;         /* 0x0000000104067827 */
        /*0030*/                   FMUL R4, R4, R9 ;                     /* 0x0000000904047220 */
        /*0040*/                   FSEL R4, R4, RZ, P1 ;                 /* 0x000000ff04047208 */
        /*0050*/                   STG.E.128 desc[UR4][R12.64], R4 ;     /* 0x000000040c007986 */
        /*0060*/              @!P0 BRA 0x10 ;                            /* 0x0000000000008947 */
        /*0070*/                   EXIT ;                                /* 0x000000000000794d */
        ..........
"""


def test_each_dropout_instance_has_its_own_count(monkeypatch):
    """``kernel_counts`` keys each instance of row 1's forward on its dropout
    argument, so a p = 0.5 site's bound reads the p = 0.5 loop (6 instructions a
    pass of 4 elements) and a p = 0 site's the p = 0 loop (4)."""
    import subprocess
    import torch

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=FWD_INSTANCES))
    counts, atomics = chip_smoke.kernel_counts({"bn_act_dropout": "lib.so"}, "cuobjdump")
    key = ("bn_act_dropout_fwd_kernel", "float32", None)
    assert counts == {key + (False,): pytest.approx(4 / 4), key + (True,): pytest.approx(6 / 4)}
    assert atomics == []
    bounds = chip_smoke.Bounds(bw=1e12, instr_rate=1e9, counts=counts)
    n = 1000
    for dropout, per_element in ((False, 1.0), (True, 1.5)):
        ms, by, _, instr_ms = bounds(8, n, "bn_act_dropout_fwd_kernel", torch.float32, None, dropout)
        assert by == "operations" and instr_ms == ms == pytest.approx(per_element * n / 1e9 * 1e3)


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
