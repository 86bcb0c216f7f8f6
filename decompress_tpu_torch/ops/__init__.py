"""Device stages of the port: LZ77 analysis, code arithmetic, the bit
packer, member inflate, CRC-32, and the CUDA kernel wrappers (``*_cu``)."""
