# width multiplier 1.0 (defaults)
