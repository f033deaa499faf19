"""Data layer: TFRecord IO, stream derivation and the batch pipeline
(counterparts of the JAX package's ``data/{proto,tfrecord,streams,
pipeline}.py``, in numpy, with no jax)."""
