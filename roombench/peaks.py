"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates, at the full power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    p = PEAKS.get(kind)
    return None if p is None else p["hbm_bytes_per_s"]
