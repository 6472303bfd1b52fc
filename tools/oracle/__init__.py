"""Faithful CPU oracle of the reference LVT pipeline (SAR-Research-Lab/lvt).

A behavior-level Python/OpenCV/NumPy reimplementation of the reference
C++ system, built to (a) generate golden trajectories that the lvt_tpu
framework is regression-tested against, and (b) measure the reference
pipeline's single-thread CPU throughput as the benchmark denominator
(BASELINE.md). Every module cites the reference file:line it mirrors.

Known, documented divergences from the reference binary:
  * Detector: cv2.FastFeatureDetector TYPE_9_16 instead of AGAST
    (this OpenCV build ships no AgastFeatureDetector). AGAST's default
    OAST_9_16 evaluates the same 9-of-16 segment-test corner criterion
    through a different decision tree; corner sets are near-identical and
    parity is judged at trajectory level (SURVEY.md section 7 hard part #2).
  * BRIEF: same algorithm as xfeatures2d::BriefDescriptorExtractor
    (9x9 box-smoothed intensity, 256 pairwise comparisons in a 48x48
    patch, 28px border removal) but with the lvt_tpu test-pair pattern
    (no xfeatures2d in this build). The pattern only needs to be
    consistent across frames; both the oracle and lvt_tpu use the same
    one, so descriptors are directly comparable.
  * PnP: g2o is not available; oracle LM mirrors g2o's
    OptimizationAlgorithmLevenberg schedule (tau=1e-5 initial lambda,
    rho-based lambda update) on the same robustified problem
    (lvt_pnp_solver.cpp:44-128) in float64.

The package root imports nothing, so tools.oracle.scenarios loads without
OpenCV (only the oracle itself needs it: tools.oracle.system).
"""
