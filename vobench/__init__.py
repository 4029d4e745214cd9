"""The benchmark of ``hso_tpu_torch``: the frame handler fed by a camera stream."""
