"""Model zoo (PyTorch): the ST-GCN eval-mode forward and its layers."""
