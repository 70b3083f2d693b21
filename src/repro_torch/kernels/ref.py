"""Plain PyTorch versions of every ported kernel, under the reference's
``repro/kernels/ref.py`` names. Each is defined beside its kernel; the CPU
path of ``ops`` runs them, and the GPU checks hold the kernels to them."""
import torch

from repro_torch.kernels.bgmv import bgmv_plain as bgmv_ref
from repro_torch.kernels.flash_attn import \
    flash_attention_plain as flash_attention_ref
from repro_torch.kernels.lora_matmul import \
    lora_matmul_plain as lora_matmul_ref
from repro_torch.kernels.paged_attn import \
    paged_attention_plain as paged_attention_ref
from repro_torch.kernels.recon_agg import recon_agg_plain
from repro_torch.kernels.verify import \
    paged_verify_attention_plain as paged_verify_ref


def recon_agg_ref(a: torch.Tensor, b: torch.Tensor, eta: torch.Tensor
                  ) -> torch.Tensor:
    """W' = Σ_k η_k · A_k B_k, the reference's single-item form:
    a (Kc, d_in, r), b (Kc, r, d_out), eta (Kc,)."""
    return recon_agg_plain(a[None], b[None], eta[None])[0]


__all__ = ["bgmv_ref", "flash_attention_ref", "lora_matmul_ref",
           "paged_attention_ref", "paged_verify_ref", "recon_agg_ref"]
