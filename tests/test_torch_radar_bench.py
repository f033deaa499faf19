"""``scripts/torch_radar_bench.py``'s reading of a ``cuobjdump -sass``
listing: the pair loop of a spline radar kernel is the smallest loop that
holds both ``sincosf``'s range reduction and a shared load, not a
slow-path loop of ``sqrtf`` or ``sincosf`` that lies near it. Runs on the
CPU on a made-up listing in cuobjdump's format."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = importlib.util.spec_from_file_location(
    "torch_radar_bench", ROOT / "scripts" / "torch_radar_bench.py")
bench = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(bench)

TWO_OVER_PI = bench.TWO_OVER_PI


def _listing(body):
    """A function of the made-up instructions ``body`` at 16-byte steps,
    in cuobjdump's layout."""
    lines = ["\t\tFunction : _Z6kernelPf",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, text in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;"
                     f"                  /* 0x0000000000000000 */")
        lines.append("                                       "
                     "                   /* 0x000fe20000000000 */")
    return "\n".join(lines)


def _kernel(slow_path_marked):
    """An outer loop (0x10 .. 0xb0) around a pair loop (0x20 .. 0xa0)
    that reads shared memory and reduces an angle; inside it, a slow
    path's loop (0x50 .. 0x70), with the 2 / pi product or without."""
    slow = (f"FMUL R4, R4, {TWO_OVER_PI}" if slow_path_marked
            else "IADD3 R4, R4, 1, RZ")
    return [
        "MOV R1, c[0x0][0x28]",            # 0x00
        "S2R R2, SR_TID.X",                # 0x10 outer loop
        "LDS.128 R8, [R2]",                # 0x20 pair loop
        f"FMUL R3, R9, {TWO_OVER_PI}",     # 0x30
        "MUFU.RSQ R5, R3",                 # 0x40
        slow,                              # 0x50 slow path's loop
        "LDG.E R6, desc[UR4][R4.64]",      # 0x60
        "@P0 BRA 0x50",                    # 0x70
        "FFMA R7, R8, R3, R7",             # 0x80
        "ISETP.NE.AND P1, PT, R2, RZ, PT", # 0x90
        "@P1 BRA 0x20",                    # 0xa0
        "@P2 BRA 0x10",                    # 0xb0
        "EXIT",                            # 0xc0
    ]


@pytest.mark.parametrize("slow_path_marked", [False, True])
def test_pair_loop_is_the_one_that_reads_shared_memory(slow_path_marked):
    report = bench.sass_report(_listing(_kernel(slow_path_marked)))
    assert report == {"_Z6kernelPf": {"instructions": 13, "pair_loop": 9,
                                      "loops": [3, 9, 11]}}


def test_a_kernel_without_a_pair_loop_has_none():
    body = ["MOV R1, c[0x0][0x28]", "LDS R2, [R1]", "@P0 BRA 0x0", "EXIT"]
    assert bench.sass_report(_listing(body)) == {
        "_Z6kernelPf": {"instructions": 4, "pair_loop": None,
                        "loops": [3]}}
