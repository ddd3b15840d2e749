"""Network modules: layers, RandLA backbone, scoring, align network."""
