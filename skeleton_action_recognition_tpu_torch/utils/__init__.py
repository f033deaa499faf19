"""Run plumbing: config and run names, the confusion-matrix image and the
TensorBoard event writer."""
