"""Engine, metrics and weight carriers of the port (inference only in this slice)."""
