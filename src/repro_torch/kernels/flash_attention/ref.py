"""Plain PyTorch version of the flash_attention kernel: over the flat
(BH, S, hd) layout (``attention_ref``, f32 inside) and over the model's
(B, S, H, hd) layout (``attention_ref_bshd``, the CPU route and the
kernel's yardstick in the tests and ``chip_smoke.py``)."""
import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  out_dtype=None) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd), any float dtypes.  Masks by row
    and column index; computes in f32 and rounds once to ``out_dtype``
    (v's dtype, as the JAX package's oracle, where not given)."""
    hd = q.shape[-1]
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) / math.sqrt(hd)
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= (qpos - kpos) < window
    s = torch.where(ok[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(
        v.dtype if out_dtype is None else out_dtype)


def attention_ref_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """The wrapper's plain version over the model's layout: q (B, Sq, H,
    hd), k and v (B, Sk, KV, hd) of any float dtypes and strides; KV heads
    repeated to H, flattened to (B*H, S, hd) for :func:`attention_ref`,
    and back.  The result is in q's dtype, as the kernel's."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)

    def flat(x):
        return x.transpose(1, 2).reshape(B * H, x.shape[1], hd)

    out = attention_ref(flat(q), flat(k), flat(v), causal=causal,
                        window=window, out_dtype=q.dtype)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)
