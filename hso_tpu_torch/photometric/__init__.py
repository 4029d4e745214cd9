from hso_tpu_torch.photometric.online_calib import (  # noqa: F401
    OnlinePhotometricCalibrator,
    correct_image,
    inverse_response_curve,
    solve_photometric,
    vignette_map,
)
