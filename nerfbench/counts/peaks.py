"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,        # tensor cores, dense
        "f32_flops": 67e12,          # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> dict:
    """The peaks of the card named `kind`; a card not in the table raises,
    so that no share is read against another card's peak."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for the card {kind!r}")
    return PEAKS[kind]
