"""The plain reference that decides ``correct``: plain PyTorch and NumPy in
f32, TF32 off, importing nothing of the port (:mod:`.plain` is a frozen copy
of the port's plain paths), and the comparisons (:mod:`.compare`)."""
