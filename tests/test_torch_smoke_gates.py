"""`chip_smoke.py`'s ptxas and SASS gates on canned nvcc logs and cuobjdump
output, on the CPU: the C7520 gate (ptxas serialized the wgmma products of
a served render kernel) names exactly the served `render_kernel` entries
that carry the warning; the training field's chain gate counts the chain
kernel's TMA stores and fails on none, on its spills and on its C7520, and
on no other kernel's. The mip-NeRF 360 phase's launches a frame follow the
frame's chunks, and its checks patch the kernel wrappers only while they
hold a frame."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K3 = "_ZN2rk13render_kernelILi256ELi10ELi0ELb0EEEvNS_7NetPtrsENS_5QuantENS_7StreamTILi96EEEPKfS6_S6_S6_PK13__nv_bfloat16PfiifPi"
K1 = "_ZN2rk13render_kernelILi256ELi10ELi0ELb1EEEvNS_7NetPtrsENS_5QuantENS_7StreamTILi96EEEPKfS6_S6_S6_PK13__nv_bfloat16PfiifPi"
K8 = "_ZN2rk15ablation_kernelILi128ELi8ELi0EEEvNS_7NetPtrsENS_5QuantENS_7StreamTILi96EEEPKfS6_S6_S6_PK13__nv_bfloat16Pfiii"
C7520 = ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to "
         "program dependence on compiler-inserted WG.AR in divergent path in the function '{}'")
C7519 = ("ptxas info    : (C7519) warpgroup.arrive is injected in around line 8021 by compiler to allow use of "
         "registers in GMMA in function '{}'")


def _entry(name, regs=168):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 16 barriers\n")


# nvcc's -Xptxas -v output as the parent of this gate printed it (the
# warnings first, each naming its function), and the same log without them.
SERIALIZED = "\n".join([C7520.format(K3), C7519.format(K1), C7520.format(K1), _entry(K3), _entry(K1)])
CLEAN = "\n".join([C7519.format(K1), _entry(K3), _entry(K1)])


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gates", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("log,want", [(SERIALIZED, [K3, K1]), (CLEAN, [])], ids=["serialized", "clean"])
def test_served_render_serialized_names_c7520_kernels(smoke, log, want):
    logs = {"fused_render_w256f10": log}
    got = smoke.served_render_serialized(list(logs), read_log=logs.__getitem__)
    assert [kernel for _, kernel, _ in got] == want
    assert all(lib == "fused_render_w256f10" and "(C7520)" in line for lib, _, line in got)


def test_served_render_serialized_skips_other_libraries_and_kernels(smoke):
    """K8's ablation library and the training field are not served render
    kernels; a C7520 line naming another kernel in a served library is not
    a render_kernel's."""
    logs = {
        "fused_render_ablate_w128f8": C7520.format(K8) + "\n" + _entry(K8),
        "train_field_w256f10v4": C7520.format(K3),
        "fused_render_w128f8": C7520.format(K8) + "\n" + _entry(K3),
    }
    assert smoke.served_render_serialized(list(logs), read_log=logs.__getitem__) == []


def test_served_render_serialized_falls_back_to_the_compiled_entry(smoke):
    """A C7520 line that names no function belongs to the entry being
    compiled when it is printed."""
    log = _entry(K1) + "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized\n"
    got = smoke.served_render_serialized(["fused_render_w64f6"], read_log={"fused_render_w64f6": log}.__getitem__)
    assert [(lib, kernel) for lib, kernel, _ in got] == [("fused_render_w64f6", K1)]


# The training field's chain kernel gate (`field_chain_stores`): cuobjdump's
# SASS of a library, one section a function, and its ptxas log.
CHAIN = "_Z22field_bwd_chain_kernel8FieldNet7StreamTILi160EEPKfS3_S3_P13__nv_bfloat1611ScratchMapsPfi"
FWD = "_Z16field_fwd_kernel8FieldNet7StreamTILi160EEPKfS3_Pfi"
TMA_STORE = "        /*1a40*/                   UTMASTG.3D [UR8], [UR4] ;"
STG128 = "        /*1b00*/              @!P0 STG.E.128 desc[UR6][R2.64], R4 ;"
HGMMA = "        /*0f30*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;"


def _sass(**bodies):
    return "\n".join(f"\t\tFunction : {name}\n" + "\n".join(lines) for name, lines in bodies.items())


def _spill(name, nbytes):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {nbytes} bytes spill stores, {nbytes} bytes spill loads\n"
            "ptxas info    : Used 232 registers, used 16 barriers\n")


CHAIN_CASES = {
    # name: (SASS, ptxas log, counts, failure words)
    "tma-stores": (_sass(**{FWD: [HGMMA], CHAIN: [HGMMA, TMA_STORE, TMA_STORE, STG128]}),
                   _spill(FWD, 0) + _spill(CHAIN, 0), {"tma_stores": 2, "stg128": 1}, []),
    "missing-stores": (_sass(**{CHAIN: [HGMMA, STG128, STG128]}), _spill(CHAIN, 0),
                       {"tma_stores": 0, "stg128": 2}, ["no TMA store"]),
    "spilling": (_sass(**{CHAIN: [HGMMA, TMA_STORE]}), _spill(CHAIN, 8), {"tma_stores": 1, "stg128": 0},
                 ["spills"]),
    "serialized": (_sass(**{CHAIN: [HGMMA, TMA_STORE]}), C7520.format(CHAIN) + "\n" + _spill(CHAIN, 0),
                   {"tma_stores": 1, "stg128": 0}, ["serialized"]),
    # Another kernel's TMA stores, spills and C7520 are not the chain's.
    "another-kernel": (_sass(**{FWD: [TMA_STORE], CHAIN: [HGMMA, STG128]}),
                       C7520.format(FWD) + "\n" + _spill(FWD, 16) + _spill(CHAIN, 0),
                       {"tma_stores": 0, "stg128": 1}, ["no TMA store"]),
}


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_field_chain_stores_gate(smoke, case):
    sass, log, counts, words = CHAIN_CASES[case]
    got, failures = smoke.field_chain_stores(sass, log)
    assert got == counts
    assert len(failures) == len(words)
    assert all(word in failure for word, failure in zip(words, failures))


@pytest.mark.parametrize("rays,want", [(76800, (188, 530)), (192, (3, 12))], ids=["320x240", "16x12"])
def test_mip360_launches_follow_the_frames_chunks(smoke, rays, want):
    """A chunk is 65,536 sample rows: 1,024 rays at 64 samples, 2,048 at
    32. K10 once a chunk; K11 once a proposal chunk, ten times (eight trunk
    layers, the bottleneck, the view and rgb layer) a NeRF chunk."""
    from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec

    got = smoke.mip360_launches(Mip360Spec(), rays)
    assert got == {"encode": want[0], "linear": want[1], "place": 3, "composite": 3}


def test_mip360_checks_patch_the_wrappers_only_inside(smoke):
    from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3

    names = ("place", "encode_slabs", "prop_density_slabs", "nerf_slabs", "composite")
    real = {k: getattr(m3, k) for k in names}
    with smoke.Mip360Checks(m3) as checks:
        for k in names:
            assert getattr(m3, k) == getattr(checks, k) and getattr(m3, k) is not real[k]
    assert all(getattr(m3, k) is real[k] for k in names)
