"""Camera + IMU + LiDAR frames whose pose was delivered inside the window,
over the window's seconds."""


def read(rec):
    return rec.delivered / rec.window_s if rec.window_s else None
