"""What decides `correct`: a follower per configuration kind (vil.py,
lidar.py) that keeps the program's odometry state before frames drawn
from the seed inside the window and, after the run, registers those
frames' scans against it with the plain float64 registration of
registration.py, holding the program's delivered poses against it. It
shares no code with the system under test."""
