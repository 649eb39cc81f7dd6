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
