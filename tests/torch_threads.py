"""One PyTorch intra-op thread for each test process.

Tier 1 runs several pytest workers at once, and PyTorch's default of one
intra-op thread per core makes their threads contend: a CPU-bound port
test then runs several times slower than it does alone (the digits
training test: 21 s alone, 172 s in a whole run). Every port test file
imports this module first, so a file run alone computes with the same
thread count as in a whole run.
"""

import torch

torch.set_num_threads(1)
