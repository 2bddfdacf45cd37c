"""Distribution math, samplers, gating init and the dequant kernel."""
