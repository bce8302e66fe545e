"""Applications on top of the port: the leveled LUT (`leveled_lut`) and the
ufhe encrypted integers (`ufhe`)."""
