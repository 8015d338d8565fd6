"""The set transformer of the port's ``nn/glob.py``
(``SetTransformerEncoder`` with sab and isab blocks,
``SetTransformerDecoder``) against the JAX package, from the same
parameters (``interop``: 3-D attention kernels, LayerNorm scales) and
inputs, on the batch of ``test_torch_glob.py``; its tolerances (outputs
within 1e-5 of max|ref|, gradients within 1e-4, key-bias gradients scaled
by their kernel's).  The attention is torch matmuls and a softmax, with
flax's masking of the padded rows of each graph's set.
"""
import pytest
import torch

from dgl_hack_tpu import nn as jnn

from dgl_hack_tpu_torch import nn as tnn
from test_torch_glob import _feat, compare, graphs  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("block,n_layers", [("sab", 1), ("sab", 2),
                                            ("isab", 1)])
def test_set_transformer_encoder(graphs, block, n_layers):
    jb, tb, *_ = graphs
    kw = dict(n_layers=n_layers, block_type=block,
              m=3 if block == "isab" else None)
    compare(jnn.SetTransformerEncoder(8, 2, 4, 16, **kw),
            tnn.SetTransformerEncoder(8, 2, 4, 16, **kw), jb, tb,
            [_feat(tb.num_nodes())], what=f"encoder {block}")


@pytest.mark.parametrize("k,n_layers", [(1, 1), (2, 0)])
def test_set_transformer_decoder(graphs, k, n_layers):
    jb, tb, *_ = graphs
    compare(jnn.SetTransformerDecoder(8, 2, 4, 16, n_layers=n_layers, k=k),
            tnn.SetTransformerDecoder(8, 2, 4, 16, n_layers=n_layers, k=k),
            jb, tb, [_feat(tb.num_nodes())], what="decoder")
