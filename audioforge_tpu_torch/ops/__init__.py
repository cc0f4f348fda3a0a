"""DSP ops over [N, T] blocks (stream axis first)."""
