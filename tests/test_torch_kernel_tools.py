"""The port's kernel tools on the CPU: the ablated copies of the flash
and popcount GEMM sources that ``zookeeper_tpu_torch.ablate`` times,
the SASS parsing of ``zookeeper_tpu_torch.sass_diff`` and its named
rename rule, the library hash of ``cuda_build``, K1's row shapes and
K2/K5's dense shapes per forward, and the variant names of the flash
kernels, K12/K13 and the int8 tensor-core kernels (K4, K5, K2). Building and running them needs
``nvcc`` and the card; these tests hold the parts that do not."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import importlib.util
import pathlib
import types

import pytest
import torch

from zookeeper_tpu_torch import ablate, sass_diff
from zookeeper_tpu_torch.ops import attention, binary_compute, cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "zookeeper_tpu_torch" / "csrc"
#: The tensor-core kernels each ablated source holds, and a part of
#: their names; every edit of an ablation touches each of them once.
TENSOR_CORE_KERNELS = {"flash_backward": (2, "_mma_kernel"), "flash_forward": (1, "_mma_kernel"),
                       "xnor_gemm": (1, "_small_m_kernel")}
#: Edits that change more than the kernel's one place (its epilogue too).
EXTRA_EDITS = {("xnor_gemm", "pm1 decode"): 1}


ABLATED = [(source, name) for source, ablations in ablate.ABLATIONS.items()
           for name, edits in ablations.items() if edits]


# The backward's cases keep the ids they had before the forward joined.
@pytest.mark.parametrize("source,name", ABLATED, ids=[
    name if source == "flash_backward" else f"{source}-{name}" for source, name in ABLATED])
def test_each_ablation_edits_both_tensor_core_kernels_once(source, name):
    """Every edit matches exactly one line of its source, so an ablation
    cannot go stale silently, and the backward's touch K10 and K11
    alike."""
    text = (CSRC / f"{source}.cu").read_text()
    edits = ablate.ABLATIONS[source][name]
    count, kernel = TENSOR_CORE_KERNELS[source]
    assert len(edits) == count + EXTRA_EDITS.get((source, name), 0)
    for old, new in edits:
        assert text.count(old) == 1, old
        assert old != new
    assert kernel in text


def test_every_ablated_source_has_the_reference_build():
    assert set(ablate.ABLATIONS) == set(TENSOR_CORE_KERNELS) | {"pack_rows"}
    assert all(ablations["as built"] == [] for ablations in ablate.ABLATIONS.values())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("path", sorted(ablate.K1_SHAPES))
def test_k1_shapes_are_the_rows_the_serving_paths_pack(path, monkeypatch):
    """``ablate.K1_SHAPES`` (which ``ablate --source pack_rows`` and
    chip_smoke time K1 at) is what K1 is given, in order, by a batch-1
    forward of the slice chip_smoke serves (E_AUTO: slice E's model on
    the fused flavor), on the CPU."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import ServingConfig

    smoke = _chip_smoke()
    settings = dict(smoke.SLICES[path.split("_")[0]][0])
    if path == "E_AUTO":
        settings["model.binary_flavor"] = "auto"
    seen, real = [], binary_compute.pack_rows

    def spy(x):
        seen.append((str(x.dtype).removeprefix("torch."), *x.shape))
        return real(x)

    monkeypatch.setattr(binary_compute, "pack_rows", spy)
    cfg = ServingConfig()
    configure(cfg, {**settings, "engine.batch_buckets": (1,), "requests": 1, "max_request": 1,
                    "seed": 0, "device": "cpu", "verbose": False})
    cfg.run()  # warms the bucket, then serves the one request: two forwards
    dtype, shapes = ablate.K1_SHAPES[path]
    forward = [(dtype, m, k) for m, k, n in shapes for _ in range(n)]
    assert seen == 2 * forward


@pytest.mark.parametrize("path", sorted(ablate.XNOR_FORWARDS))
def test_xnor_forwards_are_the_dense_layers_the_serving_paths_run(path, monkeypatch):
    """``ablate.XNOR_FORWARDS`` (the rows ``ablate --source xnor_gemm``
    sums per forward) is what K2 or K5 is given at M = batch, in order,
    by a batch-1 forward of the slice chip_smoke serves (E_AUTO: slice
    E's model on the fused flavor), on the CPU; the conv GEMMs (M = the
    output pixels) are not dense layers."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import ServingConfig

    smoke = _chip_smoke()
    settings = dict(smoke.SLICES[path.split("_")[0]][0])
    if path == "E_AUTO":
        settings["model.binary_flavor"] = "auto"
    name, shapes = ablate.XNOR_FORWARDS[path]
    seen, real = [], getattr(binary_compute, name)

    def spy(a, b, *args, **kwargs):
        if a.shape[0] == 1:
            seen.append(tuple(b.shape))
        return real(a, b, *args, **kwargs)

    monkeypatch.setattr(binary_compute, name, spy)
    cfg = ServingConfig()
    configure(cfg, {**settings, "engine.batch_buckets": (1,), "requests": 1, "max_request": 1,
                    "seed": 0, "device": "cpu", "verbose": False})
    cfg.run()  # warms the bucket, then serves the one request: two forwards
    assert seen == 2 * list(shapes)


def test_xnor_rows_are_chip_smokes_small_m_cases():
    """``ablate.XNOR_ROWS`` (the rows ``ablate --source xnor_gemm``
    times) are chip_smoke's K2 and K5 cases at M <= 8, in order, and
    hold every dense layer of ``ablate.XNOR_FORWARDS`` at batch 8."""
    smoke = _chip_smoke()
    rows = ablate.XNOR_ROWS
    for name, cases in (("xnor_matmul_packed_scaled", smoke.K2_CASES),
                        ("xnor_matmul_packed", smoke.K5_CASES)):
        assert list(rows[name]) == [(m, kw, n) for m, kw, n, _ in cases if m <= smoke.SMALL_M]
        assert all(m <= smoke.SMALL_M for m, _, _ in rows[name])
    for name, shapes in ablate.XNOR_FORWARDS.values():
        for kw, n in shapes:
            assert (ablate.K1_BATCH, kw, n) in rows[name]


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes (directly or through
    another header) renames the library, so a stale build never loads;
    an edit to a header it does not include leaves the name alone."""
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    outer = '#pragma once\n#include "inner.cuh"\n'
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\nint f() { return g(); }\n')
    (tmp_path / "outer.cuh").write_text(outer)
    (tmp_path / "inner.cuh").write_text("int g() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("int h() { return 2; }\n")
    first = cuda_build._library_path("k")
    assert cuda_build._library_path("k") == first
    (tmp_path / "other.cuh").write_text("int h() { return 3; }\n")
    assert cuda_build._library_path("k") == first
    (tmp_path / "inner.cuh").write_text("int g() { return 2; }\n")
    second = cuda_build._library_path("k")
    assert second != first
    (tmp_path / "outer.cuh").write_text(outer + "// note\n")
    assert cuda_build._library_path("k") not in (first, second)


def test_the_flash_sources_include_the_shared_header():
    for source in ("flash_forward", "flash_backward"):
        files = cuda_build._sources(str(CSRC / f"{source}.cu"), {})
        assert [pathlib.Path(f).name for f in files] == [f"{source}.cu", "mma_bf16.cuh"]


def test_the_int8_gemm_sources_include_their_shared_header():
    """K4, K5 and K3 share the int8 tensor-core helpers and block-tile
    GEMM of ``mma_s8.cuh``, so an edit there renames (rebuilds) all three
    libraries."""
    for source in ("packed_weight_matmul", "xnor_gemm", "conv_gemm_popcount"):
        files = cuda_build._sources(str(CSRC / f"{source}.cu"), {})
        assert [pathlib.Path(f).name for f in files] == [f"{source}.cu", "mma_s8.cuh"]


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN50_GLOBAL__N__cf84b836_17_flash_backward_cu_4bfeb50715flash_dq_kernelIfLi64EEEvPKT_
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;          /* 0x0000000000007919 */

\t\tFunction : _ZN50_GLOBAL__N__0123abcd_17_flash_backward_cu_89abcdef19flash_dq_mma_kernelILi64EEEvPK
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
"""


def test_parse_sass_splits_kernels_and_drops_the_namespace_tag():
    kernels = sass_diff.parse_sass(SASS)
    assert list(kernels) == [
        "_ZN50_GLOBAL__N_15flash_dq_kernelIfLi64EEEvPKT_",
        "_ZN50_GLOBAL__N_19flash_dq_mma_kernelILi64EEEvPK",
    ]
    first = kernels["_ZN50_GLOBAL__N_15flash_dq_kernelIfLi64EEEvPKT_"]
    assert first[0].startswith(".headerflags") and len(first) == 3
    assert first[1].startswith("/*0000*/") and "LDC R1" in first[1]


def test_parse_sass_compares_the_same_code_under_another_tag_as_equal():
    other = SASS.replace("cf84b836", "deadbeef").replace("4bfeb507", "01234567")
    assert sass_diff.parse_sass(other) == sass_diff.parse_sass(SASS)
    changed = SASS.replace("S2R R0, SR_TID.X", "S2R R0, SR_TID.Y")
    assert sass_diff.parse_sass(changed) != sass_diff.parse_sass(SASS)


def test_rename_pairs_a_kernel_whose_template_lost_a_parameter():
    """``--rename`` rewrites the old source's names only where the pattern
    matches: K12's kernel without its ``bool`` template argument, and not
    the wide kernel that keeps it."""
    old = {
        "_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16S1_Lb0ELi8ELi4EEEvPKT_": ["a"],
        "_ZN12_GLOBAL__N_123decode_attention_kernelIffLb1ELi8ELi4EEEvPKT_": ["b"],
        "_ZN12_GLOBAL__N_128decode_attention_wide_kernelIffLb0EEEvPKT_": ["c"],
    }
    got = sass_diff.rename(old, [r"(decode_attention_kernelI.*?)Lb0E=\1"])
    assert got == {
        "_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16S1_Li8ELi4EEEvPKT_": ["a"],
        "_ZN12_GLOBAL__N_123decode_attention_kernelIffLb1ELi8ELi4EEEvPKT_": ["b"],
        "_ZN12_GLOBAL__N_128decode_attention_wide_kernelIffLb0EEEvPKT_": ["c"],
    }
    assert sass_diff.rename(old, []) == old


SPLIT = "_ZN12_GLOBAL__N_129decode_attention_split_kernel"


@pytest.mark.parametrize("old_args,new_args", [
    ("IffLi8ELi4EEEvPKT_", "IffLb1ELi8ELi4EEEvPKT_"),
    ("I13__nv_bfloat16S1_Li16ELi2EEEvPKT_", "I13__nv_bfloat16S1_Lb1ELi16ELi2EEEvPKT_"),
    ("I13__nv_bfloat16aLi32ELi1EEEvPKT_", "I13__nv_bfloat16aLb1ELi32ELi1EEEvPKT_"),
    ("IfaLi4ELi4EEEvPKT_", "IfaLb1ELi4ELi4EEEvPKT_"),
])
def test_split_paged_rule_pairs_the_split_kernels_with_their_paged_instantiations(
        old_args, new_args):
    """The named rule ``split-paged`` gives a K13-only split kernel (no
    ``bool``) the ``PAGED=true`` argument of the template K12 and K13
    share, before its first ``int``; names that have a ``bool`` (K12's
    ``Lb0E`` instantiations, the wide kernel) are left alone."""
    keep = {f"{SPLIT}IffLb0ELi8ELi4EEEvPKT_": ["k12"],
            "_ZN12_GLOBAL__N_128decode_attention_wide_kernelIffLb1EEEvPKT_": ["wide"]}
    got = sass_diff.rename({f"{SPLIT}{old_args}": ["k13"], **keep}, ["split-paged"])
    assert got == {f"{SPLIT}{new_args}": ["k13"], **keep}
    assert sass_diff.rename(got, ["split-paged"]) == got


def test_parse_sass_ignores_the_column_padding():
    """cuobjdump pads each line to the longest instruction of the file, so
    a source that gains a longer instruction elsewhere re-pads every
    kernel: the same code padded otherwise compares equal."""
    wider = SASS.replace(" ;      /*", " ;           /*").replace(" ;          /*", " ;               /*")
    assert wider != SASS
    assert sass_diff.parse_sass(wider) == sass_diff.parse_sass(SASS)


# (dtype code, head_dim) -> library code, and the names each helper gives.
FLASH_CODES = {(1, 64): 2, (0, 64): 0, (1, 256): 1, (0, 320): 1}
DECODE_CODES = {(1, 64): 0, (0, 64): 0, (1, 256): 0, (0, 320): 1}


@pytest.mark.parametrize("which", ["forward", "backward", "decode"])
def test_flash_variant_names_the_library_code(which, monkeypatch):
    """``flash_forward_variant``, ``flash_backward_variant`` and the
    ``decode_variant`` of K12 and K13 (one dispatch rule for both) ask
    their own library and name its code through the one dict of
    variants; a code the dict does not hold raises."""
    if which == "decode":
        library, codes = "decode_attention", DECODE_CODES
        fn = "zk_decode_attention_variant"
        variant, names = attention.decode_variant, attention.DECODE_VARIANTS
        want = {(torch.bfloat16, 64): "split", (torch.float32, 64): "split",
                (torch.bfloat16, 256): "split", (torch.float32, 320): "wide"}
        error = "decode: no kernel"
    else:
        library, fn, codes = f"flash_{which}", f"zk_flash_{which}_variant", FLASH_CODES
        variant, names = getattr(attention, f"flash_{which}_variant"), attention.FLASH_VARIANTS
        want = {(torch.bfloat16, 64): "mma", (torch.float32, 64): "fma",
                (torch.bfloat16, 256): "fma_wide", (torch.float32, 320): "fma_wide"}
        error = f"flash {which}: no kernel"
    lib = types.SimpleNamespace(**{fn: lambda dtype_code, d: codes.get((dtype_code, d), -1)})
    monkeypatch.setattr(cuda_build, "library",
                        lambda name: lib if name == library else pytest.fail(name))
    assert set(names.values()) == set(want.values())
    for (dtype, d), name in want.items():
        assert variant(dtype, d) == name
    with pytest.raises(ValueError, match=error):
        variant(torch.bfloat16, 7)


@pytest.mark.parametrize("library,what,names", [
    ("packed_weight_matmul", "packed_weight_matmul", {1: "small_m", 0: "mma"}),
    ("xnor_gemm", "xnor_matmul_packed", {2: "small_m", 1: "popc", 0: "mma"}),
    ("xnor_gemm", "xnor_matmul_packed_scaled", {2: "small_m", 1: "popc", 0: "mma"}),
])
def test_gemm_variant_names_the_library_code(library, what, names, monkeypatch):
    """``packed_weight_matmul_variant``, ``xnor_matmul_packed_variant``
    and ``xnor_matmul_packed_scaled_variant`` ask their own library with
    (M, N, Kw) and name its code through the one dict of variants; a code
    the dict does not hold raises."""
    seen = []
    small_m = max(names)

    def variant(m, n, kw):
        seen.append((m, n, kw))
        return -1 if m <= 0 else (small_m if m <= 8 else 0)

    lib = types.SimpleNamespace(**{f"zk_{what}_variant": variant})
    monkeypatch.setattr(cuda_build, "library",
                        lambda name: lib if name == library else pytest.fail(name))
    helper = getattr(binary_compute, f"{what}_variant")
    table = {"packed_weight_matmul": binary_compute.PACKED_WEIGHT_VARIANTS,
             "xnor_gemm": binary_compute.XNOR_VARIANTS}[library]
    assert table == names
    assert helper(8, 4096, 288) == names[small_m] == "small_m"
    assert helper(25088, 64, 18) == names[0] == "mma"
    assert seen == [(8, 4096, 288), (25088, 64, 18)]
    with pytest.raises(ValueError, match=f"{what}: no kernel"):
        helper(0, 64, 2)
