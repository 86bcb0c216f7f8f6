"""The card's peaks the rooflines divide by: NVIDIA's data sheet for the
H100 SXM part (80 GB HBM3), at its full 700 W power limit."""

#: device-memory bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
