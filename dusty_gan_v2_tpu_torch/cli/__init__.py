"""Command lines of the port: `python -m dusty_gan_v2_tpu_torch.cli.train_gan` and
`python -m dusty_gan_v2_tpu_torch.cli.test_gan` (counterparts of train_gan.py and
test_gan.py)."""
