"""Plain PyTorch versions of every ported kernel, under the reference's
``repro/kernels/ref.py`` names. Each is defined beside its kernel; the CPU
path of ``ops`` runs them, and the GPU checks hold the kernels to them."""
from repro_torch.kernels.bgmv import bgmv_plain as bgmv_ref
from repro_torch.kernels.flash_attn import \
    flash_attention_plain as flash_attention_ref
from repro_torch.kernels.lora_matmul import \
    lora_matmul_plain as lora_matmul_ref
from repro_torch.kernels.paged_attn import \
    paged_attention_plain as paged_attention_ref
from repro_torch.kernels.verify import \
    paged_verify_attention_plain as paged_verify_ref

__all__ = ["bgmv_ref", "flash_attention_ref", "lora_matmul_ref",
           "paged_attention_ref", "paged_verify_ref"]
