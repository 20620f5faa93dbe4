"""TF32 and bf16 rounding as the tensor-core kernels do it, in plain torch:
the helpers of the CPU tests of the split products
(``tests/test_torch_rp_split.py``, ``tests/test_torch_fused_split.py``,
``tests/test_torch_dequant_split.py``).

``cvt.rna.tf32.f32`` rounds a float32 to the nearest TF32 value (10
mantissa bits), ties away from zero; the kernels split a float32 v into
hi = rna(v) and lo = rna(v - hi) (``csrc/tensor_core.cuh``).  The
backward's bf16 split is the same with ``cvt.rn.bf16x2.f32``: 8
significant bits, ties to even."""
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits to the magnitude, then clear them
    (finite inputs)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(bits >= 2**31, bits - 2**32,
                       bits).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)          # x - hi is exact in float32


def bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value (8 significant bits), ties to
    even, as ``cvt.rn.bf16x2.f32`` rounds finite inputs, kept in float32."""
    return x.to(torch.bfloat16).float()


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = bf16_rne(x)
    return hi, bf16_rne(x - hi)          # x - hi is exact in float32
