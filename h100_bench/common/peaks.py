"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at its full
700 W power limit; the run prints the card's own limit beside every share."""

HBM_BYTES_PER_S = 3.35e12  # device memory rate
