"""Engine (inference and training), losses, metrics and weight carriers of the port."""
