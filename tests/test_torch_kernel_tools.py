"""The port's kernel tools on the CPU: the ablated copies of the flash
backward source that ``zookeeper_tpu_torch.ablate`` times, and the SASS
parsing of ``zookeeper_tpu_torch.sass_diff``. Building and running them
needs ``nvcc`` and the card; these tests hold the parts that do not."""

import pathlib

import pytest

from zookeeper_tpu_torch import ablate, sass_diff

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "zookeeper_tpu_torch" / "csrc"
          / "flash_backward.cu").read_text()


@pytest.mark.parametrize("name", [n for n in ablate.ABLATIONS if ablate.ABLATIONS[n]])
def test_each_ablation_edits_both_tensor_core_kernels_once(name):
    """Every edit matches exactly one line of the source, so an ablation
    cannot go stale silently and touches K10 and K11 alike."""
    edits = ablate.ABLATIONS[name]
    assert len(edits) == 2
    for old, new in edits:
        assert SOURCE.count(old) == 1, old
        assert old != new
    assert "_mma_kernel" in SOURCE


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
