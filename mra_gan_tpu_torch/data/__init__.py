"""NIfTI IO, preprocessing and the training data pipeline: the port's own
copies of mra_gan_tpu/data/nifti.py, of the transforms of
mra_gan_tpu/data/transforms.py that its entry points use, and of
mra_gan_tpu/data/dataset.py."""
