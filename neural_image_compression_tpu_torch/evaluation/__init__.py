from neural_image_compression_tpu_torch.evaluation.anchors import (
    classical_rd_curve, classical_rd_point,
)
from neural_image_compression_tpu_torch.evaluation.bdrate import bd_psnr, bd_rate
from neural_image_compression_tpu_torch.evaluation.evaluator import (
    CompressionEvaluator, VisionCompressionEvaluator, compute_metrics, normalize_map,
)
from neural_image_compression_tpu_torch.evaluation.health import curve_health
from neural_image_compression_tpu_torch.evaluation.msssim import ms_ssim, rgb_to_luma, ssim
from neural_image_compression_tpu_torch.evaluation.viz import (
    plot_information_evolution, plot_metric_evolution,
)

__all__ = ["ms_ssim", "ssim", "rgb_to_luma", "bd_rate", "bd_psnr", "curve_health",
           "classical_rd_curve", "classical_rd_point", "CompressionEvaluator",
           "VisionCompressionEvaluator",
           "compute_metrics", "normalize_map", "plot_information_evolution",
           "plot_metric_evolution"]
