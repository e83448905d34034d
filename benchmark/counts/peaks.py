"""Published peaks by the name torch.cuda.get_device_name() gives (NVIDIA
data sheets; SXM parts at their full power limit; dense rates, no
sparsity). A card this table does not know raises: a share of a peak
never takes a default."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
    "NVIDIA H200": {"bf16_flops": 989e12, "hbm_bytes_per_s": 4.8e12},
}


def peak(card: str, key: str) -> float:
    """The card's `key` peak; raises for a card the table lacks."""
    if card not in PEAKS:
        raise ValueError(f"no published peaks known for the card {card!r}; "
                         f"add them to benchmark/counts/peaks.py")
    return PEAKS[card][key]
