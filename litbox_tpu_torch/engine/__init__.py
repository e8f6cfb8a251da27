from .simulation import Mode, Simulation, Strategy

__all__ = ["Mode", "Simulation", "Strategy"]
