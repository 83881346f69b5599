"""The port's ``scripts/data`` apps: dataset preparation, 3-D conversion,
PSF plots and the hub upload."""
