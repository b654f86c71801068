from repro_torch.roofline.analysis import HW, RooflineReport, analyze

__all__ = ["RooflineReport", "analyze", "HW"]
