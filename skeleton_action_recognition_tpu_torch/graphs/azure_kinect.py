"""Azure Kinect 32-joint body-tracking skeleton (the edges the VirtualRadar
demo uses).

Counterpart of ``skeleton_action_recognition_tpu/graphs/azure_kinect.py``:
the 26-edge list of the reference's Azure Kinect loader (``utils.py:31-37``).
"""

AZURE_KINECT_EDGES = [
    (1, 0), (2, 1), (3, 2), (4, 2),
    (5, 4), (6, 5), (7, 6), (8, 7),
    (9, 8), (10, 7), (11, 2), (12, 11),
    (13, 12), (14, 13), (15, 14), (16, 15),
    (17, 14), (18, 0), (19, 18), (20, 19),
    (21, 20), (22, 0), (23, 22),
    (24, 23), (25, 24), (26, 3),
]
