"""The port's ``scripts/hardware`` apps: the DigiCam's mask and its
distance to the sensor, set over SSH."""
