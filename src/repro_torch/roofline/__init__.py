"""Hardware bounds for the port on one NVIDIA H100: the card's peak rates
(``hw``), the compulsory bytes and operations of each CUDA kernel
(``kernels``), and the packets-per-second bound of a whole dataplane
dispatch (``dataplane``)."""
