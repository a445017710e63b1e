"""The paper's own BNN configurations (for the switch-chip pipeline).

These describe the fully-connected binary networks N2Net compiles, not the
LM architectures.  ``HEADLINE`` is the paper's closing example: "960 million
two-layers-BNNs per second, using 32b activations (e.g., the destination IP
address of the packet), and two layers of 64 and 32 neurons."
"""
from repro_torch.core.bnn import BnnSpec

# Paper §2 Evaluation / §3 examples.
HEADLINE = BnnSpec((32, 64, 32))          # dst-IP classifier, 1 pipeline pass
SINGLE_NEURON_2048 = BnnSpec((2048, 1))   # Table 1 right edge: 25 elements
TABLE1_WIDTHS = (16, 32, 64, 128, 256, 512, 1024, 2048)

# A DoS white/blacklist-style classifier over a 104-bit 5-tuple
# (src ip, dst ip, src port, dst port, proto) padded to 128 bits.
FIVE_TUPLE = BnnSpec((128, 64, 32, 2))
