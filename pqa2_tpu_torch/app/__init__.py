"""Engine layer: VMAFAnalyzer with the reference's results dict and artifacts."""
