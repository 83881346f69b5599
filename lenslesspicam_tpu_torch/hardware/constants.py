"""Hardware constants (port of lenslesspicam_tpu/hardware/constants.py).

Raspberry Pi HQ camera (IMX477) calibration facts used by the ISP chain
(data/image.py bayer2rgb_cc).
"""

import numpy as np

RPI_HQ_CAMERA_BLACK_LEVEL = 256.3

RPI_HQ_CAMERA_CCM_MATRIX = np.array(
    [
        [2.0659, -0.93119, -0.13421],
        [-0.11615, 1.5593, -0.44314],
        [0.073694, -0.4368, 1.3636],
    ]
)
