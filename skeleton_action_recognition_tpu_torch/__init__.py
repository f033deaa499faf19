"""PyTorch and CUDA port of ``skeleton_action_recognition_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference. Module names follow it:

* ``graphs`` — the NTU RGB+D spatial-partition adjacency and bone pairs;
* ``models`` — ``stgcn.Model`` (train and eval, remat, trainable
  adjacency), ``gcn.GraphConvTD``, the Keras-semantics
  ``layers.BatchNorm`` and ``layers.l2_regularization``;
* ``ops``    — ``sgcn.fused_graph_conv``, the hand-written CUDA spatial
  graph-conv kernels, forward (``csrc/sgcn_fwd.cu``) and backward
  (``csrc/sgcn_bwd.cu``), beside their plain versions, and ``build``,
  which compiles ``csrc/`` with ``nvcc`` at first use;
* ``data``   — TFRecord IO, the bone/motion streams and ``TFRecordDataset``;
* ``train``  — losses, the piecewise schedule, Keras-2 SGD (``TFSGD``),
  train/eval steps, metrics and checkpoints;
* ``parallel`` — ``prefetch_to_device`` (pinned memory, a copy stream);
* ``utils``  — ``config.yaml``, run names, the confusion PNG and the
  TensorBoard event writer;
* ``cli.main_gnn`` — the GNN trainer;
* ``interop`` — flax variables <-> the port's ``state_dict``;
* ``serving`` — ``Predictor``, softmax probabilities for request batches.

Nothing here imports jax or the JAX package.
"""

__version__ = "0.2.0"
