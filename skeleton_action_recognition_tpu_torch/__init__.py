"""PyTorch and CUDA port of ``skeleton_action_recognition_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference. Module names follow it:

* ``graphs`` — the NTU RGB+D spatial-partition adjacency (numpy);
* ``models`` — ``stgcn.Model`` (eval-mode forward), ``gcn.GraphConvTD`` and
  the Keras-semantics ``layers.BatchNorm``;
* ``ops``    — ``sgcn.fused_graph_conv``, the hand-written CUDA spatial
  graph-conv kernel (``csrc/sgcn_fwd.cu``) beside its plain version, and
  ``build``, which compiles ``csrc/`` with ``nvcc`` at first use;
* ``interop`` — flax variables -> the port's ``state_dict``;
* ``serving`` — ``Predictor``, softmax probabilities for request batches.

Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
