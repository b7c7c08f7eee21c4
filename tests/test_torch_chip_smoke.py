"""chip_smoke.py's reading of nvcc's ptxas report, on which its build
phase fails a kernel that spills.  CPU-only: the report is text."""

import pytest

import chip_smoke

# Two entries as `nvcc -Xptxas -v` prints them for each kernel instance.
_ENTRY = """ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'
ptxas info    : Function properties for {mangled}
    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers
"""
_PREFIX = "_ZN51_GLOBAL__N__459cc6d3_18_flash_attention_cu_2c138979"


def _log(*entries):
    return "".join(_ENTRY.format(**e) for e in entries)


@pytest.mark.parametrize(
    "mangled, name",
    [
        (_PREFIX + "26flash_bwd_dkv_wgmma_kernelILi128ELi32EEEv14CUtensorMap_stS1_S1_S1_PKf",
         "flash_bwd_dkv_wgmma_kernel<128, 32>"),
        (_PREFIX + "25flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKf",
         "flash_bwd_dq_wgmma_kernel<64>"),
        (_PREFIX + "21flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiiif",
         "flash_fwd_bf16_kernel<128>"),
        (_PREFIX + "22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16"
         "Pfiiiiif", "flash_fwd_wgmma_kernel<64>"),
        (_PREFIX + "22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16"
         "Pfiiiiif", "flash_fwd_wgmma_kernel<128>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelI13__nv_bfloat16"
         "Li128ELi1EEEvNS_6ParamsE", "paged_decode_kernel<bf16, 128, 1>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelIfLi16ELi8EEEv"
         "NS_6ParamsE", "paged_decode_kernel<float, 16, 8>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelI13__nv_bfloat16"
         "Li128EEEvPKT_", "paged_decode_kernel<bf16, 128>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelIfLi64EEEvPKT_",
         "paged_decode_kernel<float, 64>"),
    ],
)
def test_ptxas_report_names_each_instance(mangled, name):
    rows = chip_smoke.ptxas_report(
        _log(dict(mangled=mangled, stack=0, stores=0, loads=0, regs=168)))
    assert rows == [(name, "Used 168 registers, used 1 barriers; 0 bytes stack frame, "
                           "0 bytes spill stores, 0 bytes spill loads", 0)]


def test_ptxas_report_reads_each_instances_own_spill_stores():
    log = _log(
        dict(mangled=_PREFIX + "26flash_bwd_dkv_wgmma_kernelILi128ELi64EEEv", stack=24,
             stores=28, loads=48, regs=168),
        dict(mangled=_PREFIX + "25flash_bwd_dq_wgmma_kernelILi128EEEv", stack=0, stores=0,
             loads=0, regs=168),
    )
    rows = chip_smoke.ptxas_report(log)
    assert [(name, stores) for name, _, stores in rows] == [
        ("flash_bwd_dkv_wgmma_kernel<128, 64>", 28), ("flash_bwd_dq_wgmma_kernel<128>", 0)]
