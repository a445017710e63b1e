"""N2Net core: the paper's contribution.

``bitops``     — uint32 bit primitives on int64 carriers (popcount, packing).
``bnn``        — binary NN definition + mathematical oracle.
``phv``        — 512B Packet Header Vector model and field allocator.
``pipeline``   — RMT instruction set, elements, chip spec, cost model.
``compiler``   — BNN weights -> pipeline program (the paper's 5 steps).
``interpreter``— PyTorch executor with exact RMT element semantics.
"""
