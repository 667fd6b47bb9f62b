"""Command lines of the port: `python -m dusty_gan_v2_tpu_torch.cli.train_gan`,
`.cli.test_gan`, `.cli.train_semseg` and `.cli.test_semseg` (counterparts of train_gan.py,
test_gan.py, train_semseg.py and test_semseg.py)."""
