#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gpboost_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --phases 23-26 [--vlb-maxit 0]
                                     # phases 1-2 and the groups asked for
                                     # (3-8, 9-14, 15-19, 20-22, then 23,
                                     # 24, 25, 26 each alone, 27-29, 30-32,
                                     # 33-35, 36-38, 39-41, 42-44, 45-47,
                                     # 48-50 and 51-53); no result lines

Phases; any failure exits non-zero and prints no result line:
  1. device: needs CUDA (no CPU fallback); prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the histogram kernels (csrc/histogram.cu and
     csrc/hist_masked.cu around csrc/hist_common.cuh, one nvcc each,
     started together) from the checkout's sources and prints the build
     seconds and what ptxas reports;
  3. kernel checks, hist_segment: at the GPBoost slice's shapes (n = 10,000
     rows, p = 5, the dataset's real bin count; uint8 and int32 bins; root,
     unaligned, empty and one-row segments, a feature whose rows all fall
     in one bin; host-int, 0-dim tensor and (2,) device-pair segments) the
     kernel must equal its fixed-point emulation bit for bit, equal itself
     across two launches and under a permutation of the segment's rows, and
     match the plain version (counts exact, grad/hess to 1e-4); then at the
     serial learner's shapes of boosting_n200k_p50 (n = 200,000, p = 50,
     uint8; whole and half segment, one-bin feature; the plain version
     timed on the whole segment). Times: CUDA events
     around the wrapper (median of 25, host work included) and the kernel's
     own device time from torch.profiler (mean of 25), beside the plain
     version's;
  4. the GPBoost slice at full size: the bench configuration w_gpboost1000
     (n = 10,000, p = 5, 2-D coordinates, exponential kernel, Vecchia with
     20 neighbours, 31-leaf trees, learning rate 0.1, float32 engine,
     sim_gpboost data with seed 1) for 10 rounds, then predict on 1,000 new
     points; hist_segment's launch count over that run must be positive;
  5. card vs CPU: the same slice at n = 2,000 in float64 on the card (with
     the kernel) and on the CPU (plain version): first tree, covariance
     parameters and predictions;
  6. kernel checks, hist_masked and hist_block: at the boosting slice's
     shapes (p = 50; n = 200,000 and a ragged n; the dataset's real bin
     count; uint8 and int32 bins and a one-bin feature; targets that select
     about half the rows, none, one row, and a device-tensor target), the
     same checks as phase 3 (emulation, two launches, a row permutation,
     plain version to 1e-5 of the largest entry), a NaN grad (that channel
     NaN in every bin, the others exact), and the same times;
  7. the parallel boosting slice at full width: the bench configuration
     boosting_n200k_p50 (sim_boost, n = 200,000, p = 50, seed 2, 31 leaves,
     learning rate 0.1, Gaussian regression, no GP model) for 20 rounds
     with tree_learner="data" on a one-rank NCCL group; hist_masked's
     launch count over that run must be positive. Then 3 rounds each of
     the feature and voting (top_k 20) learners (5 before phases 48-50),
     which at one rank must
     grow the data learner's trees, and one round of the serial positional
     learner (hist_segment), whose tree must equal the data learner's first
     under phase 5's float32 near-tie rule. Device busy share from a
     torch.profiler window over two more rounds;
  8. two ranks on one card: spawn_train with gloo on CUDA tensors at
     n = 20,000, data, feature and voting (top_k 25), against the one-rank
     data learner's trees; predictions to 1e-5;
  9. kernel checks, hist_segment at the grouped slice's shapes (n = 100,000,
     p = 6 and its first 5 features, uint8, the real bin count; whole and
     part segments, a one-bin feature): phase 3's checks and times;
 10. the grouped slice at full width: GPBoost with a grouped random
     intercept on examples/03_gpboost_algorithm.py's data at n = 100,000,
     q = 1,000 groups, p = 6, seed 1 (31 leaves, learning rate 0.1,
     min_data_in_leaf 20, float64) for 10 rounds, then predict on 1,000 new
     rows, half in unseen groups; first-fit and per-round seconds, the host
     syncs of one steady round (torch.cuda sync debug mode), the device
     busy share of two more rounds; hist_segment's launch count over the 10
     rounds must be positive;
 11. the R suite's n = 100,000 grouped GPBoost goldens (62 rounds; the
     line-search step length at learning rate 0.5) at their own tolerances;
 12. card vs CPU for phase 10 at the example's size (n = 2,000, q = 50),
     float64: trees under phase 5's near-tie rule, covariance parameters to
     rtol 1e-4, predictions to 1e-4;
 13. Gaussian fits on the card: the LMM of examples/01 at n = 100,000,
     q = 1,000 with X and standard errors; exact GPs at n = 500 (against the
     CPU, rtol 1e-4) and n = 5,000;
 14. the headline Vecchia fit (bench.py:231-245, n = 100,000, m = 20,
     float32, lbfgs, maxit 30): it must take the device L-BFGS; iterations,
     seconds and host syncs, beside the forced scipy path's;
 15. the binary GLMM at full width: bench.py's grouped_glmm (sim_glmm,
     n = 100,000, q = 1,000, seed 5, bernoulli_logit, maxit 50) on the
     grouped Laplace engine's padded mode finder; it must take the device
     L-BFGS. First fit, then a second after reset_fit: seconds, iterations,
     host syncs, device busy share (a third fit under torch.profiler) and
     the variance, held to a CPU fit of the port (variance to rtol 1e-4,
     iterations equal); the reference library's time from
     BASELINE_MEASURED.json beside it;
 16. a crossed Poisson GLMM at full width (n = 100,000, groupings of 1,000
     and 100 levels, seed 5): the rows mode finder with a 1,100 x 1,100
     Cholesky per Newton step; the numbers of phase 15;
 17. LaGaBoost at full width: examples/04_non_gaussian.py:40-49 scaled to
     n = 100,000, q = 1,000 (p = 5, bernoulli_logit, 15 leaves, learning
     rate 0.1) for 10 rounds, then predict the response for 1,000 new
     rows, half in unseen groups, whose latent mean must be exactly 0;
     init-score and first-fit seconds, seconds per round, host syncs of one
     steady round, device busy share of two more, hist_segment launches
     (must be positive);
 18. the goldens of tests/test_lagaboost_golden.py TestBinaryGrouped
     (ntrain 1,000, crossed groupings, bernoulli_probit, 30 rounds) at
     that file's tolerances;
 19. card vs CPU: phase 17 at n = 2,000, q = 50 in float64 (trees under
     phase 5's near-tie rule, covariance parameters to rtol 1e-4,
     predictions to 1e-4); the dense Laplace engine on a bernoulli_probit
     exponential GP at n = 500 (card against CPU, rtol 1e-4) and at
     n = 5,000, timed;
 20. bench.py's vecchia_laplace_n20k at full width (sim_vl, n = 20,000,
     seed 3, bernoulli_probit, exponential, 20 neighbours, the dense
     precision path, float32, maxit 20, init_cov_pars [1.0, 0.1]): one
     fit (seconds, iterations, Newton steps, host syncs, peak device
     memory); the reference library's time beside it; one float64 fit of
     the same data with its covariance parameters beside float32's (a
     third, profiled fit was cut for phases 23-26, the second after
     reset_fit for phases 27-29);
 21. hist_segment at its shapes (n = 20,000, p = 5, uint8: phase 3's
     checks and times), then binary Vecchia LaGaBoost at n = 20,000
     (sim_lagab, p = 5, seed 4; the GP model of phase 20 with its default
     initial values; 31 leaves, learning rate 0.1) for 1 round (10 before
     phases 23-26, 3 before phases 39-41), then the response on 1,000 new
     points: init-score and
     first-fit seconds, seconds per round, host syncs and device busy
     share of one steady round (each in a round of its own before the
     script's time limit forced the cut, two busy rounds before phases
     27-29);
     hist_segment launches (must be positive);
 22. card vs CPU at n = 1,000 (2,000 before the script's time limit forced
     the cut) in float64 (random ordering): the engine's
     NLL, g_u and g_F to rtol 1e-8 with equal Newton steps, a fit (rtol
     1e-4, equal iterations), 1 LaGaBoost round (3 before phases 39-41;
     phase 5's near-tie rule,
     predictions to 1e-4); then the R goldens of
     tests/test_vecchia_laplace_golden.py on the card at that file's
     tolerances;
 23. the iterative methods' pieces, card against CPU: pcg, pcg_it's
     per-column counts, pcg_batched, an SLQ log-determinant and its
     gradient, the pivoted Cholesky (rtol 1e-9, counts equal); the
     Vecchia operators B v and B'w at n = 2,000 against B built densely
     (1e-12), B'w bitwise equal across two launches;
 24. the reference's vecchia_laplace_n20k as it runs it
     (bench_reference.py:229-236): phase 20's data and model with
     matrix_inversion_method "iterative" (vadu), float64: one fit (the
     second, after reset_fit, was cut for phases 27-29; seconds,
     iterations, Newton steps, CG
     iterations, host syncs, peak device memory; no float64 solve may stop
     at cg_max_num_it), the device busy share of one NLL and gradient, the
     matrix-free operator's times (a CG iteration, an S_J application, a
     Lanczos step) beside their byte bounds, the covariance parameters
     against phase 20's dense float64 fit (rtol 1e-1), the reference's
     60.302 s; then one float32 fit, capped at 1 iteration since phases
     48-50 came (2 since 45-47, 3 since 39-41), with its solves at
     cg_max_num_it;
 25. hist_segment at n = 50,000, p = 5 (phase 3's checks and times), then
     binary Vecchia LaGaBoost at the reference's n = 50,000 (sim_lagab,
     seed 4; bench_reference.py:90-99, :190-203), iterative, float64, 31
     leaves, learning rate 0.1, cut in depth to 2 rounds with the GP
     model's first fit capped at 5 iterations (--vlb-maxit): init-score
     and first-fit seconds, seconds per round and each round's GD refit
     (iterations, NLL and gradient evaluations, seconds, CG), host syncs
     of the second round, device busy share of one gradient, CG totals
     (none at cg_max_num_it), peak device memory (below one n x n float64
     matrix), hist_segment launches (must be positive), the operator's
     times (B'w also against SegmentSum); the response on 1,000 new
     points with 500 simulation draws; the reference's 2,870.2 s for 10
     rounds beside;
 26. card against CPU at n = 500, iterative, float64, 5 probes, fits
     capped at 2 iterations (n = 2,000, 10 probes and 3 before phases
     39-41, then n = 1,000 until the script's time limit forced the
     cut): the engine's NLL (rtol 1e-6), g_u and g_F
     (1e-4) and Newton steps, a fit (1e-3, equal iterations), 2 LaGaBoost
     rounds with the default per-round GD refit (3 rounds without it
     before; the CPU side of a refit is the cost): each refit's steps on
     both sides, which must be the same GD decisions (parameters 1e-4,
     NLLs 1e-8) or part only at a decision taken on NLLs within 1e-8,
     trees under phase 5's near-tie rule, predictions to 1e-4; then the
     grouped iterative branch at q = 25,000 (n = 100,000), which auto
     takes, against the Cholesky branch on the card (NLL 1e-4, gradient
     1e-1, fit 1e-2);
 27. Vecchia prediction at the headline's width: phase 14's data and model
     (sim_vecchia, n = 100,000, m = 20, random ordering, exponential) in
     float64, fitted on the device L-BFGS; then set_prediction_data and
     predict at 10,000 new points (seeded, unit square) for each of the
     five vecchia_pred_types, means and variances (the latent
     cond_all ordering: means at 10,000, variances at 200 points, 500
     until phases 45-47 came, 1,000 before phases 39-41), each with
     seconds, host syncs, CG iterations (latent) and peak device
     memory; the latent mean bitwise equal in a second launch;
     predict_training_data_random_effects at n = 100,000; one float32
     latent solve's CG iterations; card against
     CPU at n = 2,000 (200 points, fixed parameters) for every ordering and
     the training random effects, to 1e-8 of the largest value (the latent
     CG 1e-6);
 28. weights and clusters at full width: the headline fit with weights
     w = 0.5 + 2u (u from the script's LCG), float32, which must take the
     device L-BFGS; a clustered Vecchia fit at n = 100,000 in 100 clusters
     of 1,000 points (independent realizations at 1,000 fixed locations;
     no conditioning set may cross a cluster); phase 10's grouped GPBoost
     (n = 100,000, q = 1,000) with those weights on the GPModel for 10
     rounds: seconds per round, host syncs of round 11, hist_segment
     launches (must be positive); a dense exact GP with cluster_ids at
     n = 5,000 in 10 clusters;
 29. Nesterov GPBoost: w_gpboost1000 (n = 10,000, float32) with
     use_nesterov_acc for 10 rounds, then predict at 1,000 new points:
     seconds per round, GP refits per round, hist_segment launches (must
     be positive); card against CPU at n = 2,000, float64, 5 rounds, for
     Nesterov GPBoost, the weighted grouped GPBoost (q = 50) and the
     clustered dense GP (10 clusters): trees under phase 5's near-tie
     rule, covariance parameters to rtol 1e-4, predictions to 1e-4;
 30. the objectives at full width: boosting_n200k_p50's data (phase 7's
     binned Dataset; labels from the same draw: binary 1{y > median},
     poisson and tweedie Poisson(exp(0.5 (y - mean))) with seed 5,
     cross_entropy the logistic of y - mean, l1, quantile (alpha 0.9),
     huber, fair and mape y itself), 31 leaves, learning rate 0.1, the
     serial learner, and binary with bagging_fraction 0.8, bagging_freq 1,
     feature_fraction 0.8: one warm-up round, 5 timed rounds, the host
     syncs of one more, hist_segment launches (each positive), peak memory;
     card against CPU at n = 2,000 for 3 rounds of each: init scores
     equal, trees under phase 5's near-tie rule, predictions after the
     output transform to 1e-6 over the trees before any near-tie;
 31. validation and early stopping at full width: (a) binary boosting on
     phase 30's rows with 50,000 rows of sim_boost(seed=3) labelled by the
     training median, binary_logloss, learning rate 0.3, up to 150 rounds,
     early stopping 10: rounds, seconds a round with and without the
     validation, host syncs of a steady round with and without it,
     best_iteration = argmin + 1 of the recorded metric, and
     predict(num_iteration=best_iteration) gives that metric back to
     1e-12; (b) phase 10's grouped GPBoost with 20,000 validation rows
     through gp_valid_data (50 levels unseen in training), l2 and
     test_neg_log_likelihood, up to 60 rounds, early stopping 5; (c)
     w_gpboost1000 (n = 10,000, m = 20, float32) with 2,000 validation
     points through gp_coords_pred, l2, 20 rounds, early stopping 5, the
     neighbour search timed; (d) phase 17's LaGaBoost with 20,000
     validation rows, binary_logloss, 5 rounds;
 32. cv of grouped GPBoost on phase 10's generator at n = 20,000, 4 folds,
     l2, up to 40 rounds, early stopping 5 (seconds, seconds a
     fold-round, best_iter = argmin + 1, hist_segment launches), then
     grid_search_tune_parameters over learning_rate {0.05, 0.1} x
     min_data_in_leaf {20, 100}, 1 random try of 10 rounds (2 of 20
     before phases 39-41, 1 of 20 before 45-47); card
     against CPU at n = 1,000 (q = 50): cv mean and stdv curves to 1e-6
     over the rounds before any near-tie, best_iter and grid search's
     best_params equal;
 33. FITC at the headline's width: sim_vecchia n = 100,000 (2-D), 500
     kmeans++ inducing points, float64: the host kmeans++ seconds (the
     JAX package's centres, draw for draw) within the setup, a fit
     (device L-BFGS, init_cov_pars [0.5, 1.0, 0.1]: seconds, iterations,
     host syncs, peak memory), predictions with variances at 10,000
     points; card against CPU at n = 2,000 (NLL at fixed parameters, a
     30-iteration gradient-descent fit, predictions; relative 1e-8, equal
     iterations); FITC GPBoost on w_gpboost1000's data (n = 10,000,
     p = 5, 31 leaves, float64) for 10 rounds: seconds a round, host syncs
     of round 11, device busy share of rounds 12-13, hist_segment launches
     (must be positive);
 34. FITC-Laplace: bernoulli_probit on sim_lagab (seed 4) at n = 50,000
     with 500 kmeans++ inducing points, maxit 20: kmeans++, fit seconds,
     iterations, Newton steps, host syncs, peak memory; FITC LaGaBoost on
     the same data for 3 rounds (31 leaves), each round's seconds,
     hist_segment launches (must be positive); Poisson card against CPU at
     n = 1,000 with 100 inducing points (NLL, g_u, g_F and predictions
     1e-8 relative, equal Newton steps);
 35. tapering, full-scale tapering and full-scale Vecchia (distance- and
     correlation-based) on the dense engine, card against CPU at
     n = 2,000 (NLL and predictions at fixed parameters, 1e-8 relative),
     GPBoost with Newton leaves on the full-scale tapering adapter (taper
     range 0.1, 100 inducing points) on w_gpboost1000's generator at
     n = 2,000 for 1 round (3 before phases 39-41) card against CPU
     (phase 12's rule: trees,
     parameters, scores and predictions to 1e-4),
     tapering and full-scale tapering at a taper range of 1e6 equal to the
     exact engine's NLL (1e-10); the iterative full-scale tapering (taper
     range 0.02, shape 1, 100 inducing points) and full-scale Vecchia
     (100 inducing points, 30 neighbours) fits at n = 20,000 (lbfgs,
     maxit 10, 20 before phases 45-47): kmeans++, seconds, iterations,
     host syncs, peak memory, CG solves, iterations and those at cg_max_num_it;
 36. the combined Vecchia GP + grouped random effects engine at full
     width: binary LaGaBoost on sim_combined (n = 50,000 rows on 10,000
     sites, q = 1,000 groups, seed 4; bernoulli_probit, exponential, 20
     neighbours, float64, "auto" = the iterative formulation, vadu; 31
     leaves, learning rate 0.1) for 1 round (3 before phases 39-41) with
     the GP model's first fit capped at 5 iterations (phase 25's cut):
     the fit's seconds,
     iterations, Newton steps, CG iterations and solves at cg_max_num_it,
     host syncs and peak device memory; seconds a round and each round's
     GD refit, the device busy share of one gradient, hist_segment launches
     (must be positive); then 1,000 predictions with variances, half in
     unseen groups (whose latent variance must be the larger);
 37. GPBoost with a Gaussian response on the combined model (LaGaBoost
     over gaussian_latent, iterative) at n = 20,000: the first fit capped
     at 1 iteration, then 1 round with the parameters held (3 and 2
     before phases 39-41, 2 and 1 before 45-47)
     (train_gp_model_cov_pars False), hist_segment launches (must be
     positive);
     the dense and the iterative formulation at
     n = 2,000 (NLL within 5e-3 relative); two crossed groupings
     (q = 1,000 and 200) at n = 20,000: ssor's Newton CG iterations no more
     than vadu's, NLLs to 1e-4; an exact GP with a grouped effect, gamma,
     n = 2,000, on the dense Laplace engine (maxit 20);
 38. card against CPU, float64, relative 1e-8: the combined engine's dense
     formulation (gamma) and iterative one (probit, the same probes) at
     n = 500 (1,000 before phases 45-47; NLL, g_u, g_F, Newton steps, CG
     iterations, predictions
     with variances; the iterative variances, a batched CG, to 1e-6), the
     exact GP with a grouped effect (probit,
     n = 500), a Gaussian Vecchia Newton fit (n = 500, iterations
     equal), one combined LaGaBoost round (n = 500; the init score and
     the first fit to 1e-8, then phase 12's rule).
 39. GP random coefficients at full width: the R suite's combined SVC
     model (tests/test_combined_gp_re_golden.py:661-742: an exponential GP
     with two random-coefficient processes, two crossed groupings with a
     slope on the first, 10 covariance parameters) on sim_svc (that
     file's fixture at n = 5,000 from a numpy seed, plus sim_gpboost's
     F(X), p = 5), float64, the dense engine: hist_segment at its shapes
     (phase 3's checks, bit for bit), GPBoost with 31 leaves for 10
     rounds (first-fit seconds, iterations, host syncs; seconds a round;
     peak memory; the device busy share of one more round; hist_segment
     launches, which must be positive), 1,000 predictions with
     gp_rand_coef_data_pred and variances, and 1,000 posterior draws at
     200 points, whose sample means and covariances must lie within
     Monte-Carlo limits of the predicted ones;
 40. optimizer_cov="adam" on phase 13's LMM (n = 100,000, q = 1,000,
     with X) and phase 15's binary GLMM, each beside lbfgs on the same
     data (iterations, seconds, NLL); a binary probit SVC model on the
     dense Laplace engine at n = 2,000 (hist_segment at its shapes
     first, phase 3's checks): the fit, 3 LaGaBoost rounds,
     500 latent predictions with 1,000 posterior draws (Monte-Carlo
     limits) and 1,000 prior draws;
 41. card against CPU at n = 500, float64: SVC GPBoost for 2 rounds (the
     first fit printed; trees under phase 5's rule, covariance parameters
     and predictions after them), both adam fits (iterations equal),
     posterior and prior draws at one seed element by element, the
     probit SVC model's Laplace NLL and gradients (1e-10), the rest to
     1e-8 relative.
 42. the likelihood families at full width: two-predictor LaGaBoost,
     zero_inflated_regression_poisson on sim_zi (n = 100,000, q = 1,000,
     p = 5, seed 42: a grouped effect in the mean block and a
     structural-zero probability sigmoid(zeta(X)); phase 17's widths, 15
     leaves, learning rate 0.1, float64) for 10 rounds of two trees, each
     round refitting by a full device L-BFGS fit (as the reference does
     for two predictor sets): the init scores' and the first fit's
     seconds, iterations and Newton steps, the seconds of each round, the
     host syncs of round 8 by Python line, the device busy share of
     rounds 9-10, 1,000 predictions (half in unseen groups, whose latent
     means must be exactly 0; response means finite and >= 0),
     hist_segment launches (must be positive); then the one-predictor
     zero_inflated_negative_binomial GLMM (two aux parameters) at the same
     width: fit seconds, iterations, syncs. Budget: ~30 s;
 43. the other engines at reduced size, each fit's seconds, iterations,
     syncs and peak memory: the dense engine's W+/W- path
     (zero_inflated_poisson, an exponential GP, n = 2,000, 10 iterations),
     two random-effect sets (gaussian_heteroscedastic_fixed_and_random,
     n = 1,000, a 2,000 mode), both Vecchia-Laplace engines with
     zero_inflated_regression_poisson (n = 5,000, m = 20, 2 iterations;
     the matrix-free one with 10 SLQ probes), FITC-Laplace with
     hurdle_regression_lognormal (n = 20,000, 200 kmeans++ points, 2
     iterations) and asymmetric_laplace_tkc on phase 42's groups (5
     iterations; the curvature searches' host reads). Budget: ~10 s;
 44. card against CPU: all 34 families at n = 1,000 (log_lik, d1, d2,
     fisher_W / fisher_W2, the derivatives in zeta; 1e-12 relative, d2
     through trigamma or log_ndtr's backward 1e-9), the tkc curvature and
     its gradient, the two-predictor grouped engine's NLL, g_u and g_F
     (1e-10) and a two-predictor LaGaBoost of 2 rounds at n = 500
     (round by round: split records equal but for thresholds moved at
     equal float32 gains, which cut the rows alike, or up to a near tie of
     phase 5's rule; init scores and each round before any near tie, the
     first always: covariance parameters to 1e-8, the training score and
     the predictions at the new rows outside every moved threshold's
     interval to 1e-6, float32 leaf sums); the goldens of
     tests/test_two_predictor_golden.py's TestHurdleRegressionLognormal
     and its Poisson evaluation on the card at that file's tolerances.
     Budget: ~15 s.
 45. space-time GPBoost at full width: sim_space_time (n = 100,000, time
     binned into 1..20 as the R suite's space-time simulation, locations
     uniform on the unit square, sim_gpboost's F of p = 5 covariates)
     with matern_space_time (shape 1.5), Vecchia with 20 neighbours in
     the time ordering, float64, 31 leaves, for 10 rounds; the first fit
     capped at maxit 20 (two chunks on the device L-BFGS, the neighbour
     sets re-determined in the range-scaled space after each): the first
     search's, the fit's and each re-determination's seconds, the
     fit's iterations and its NLL below the initial values', seconds a
     round, host syncs of round 11, device busy share of rounds 12-13,
     1,000 predictions, hist_segment launches (must be positive); card
     against CPU at n = 2,000 (gradient descent, maxit 20): equal
     iterations, re-determinations and neighbour sets, parameters to
     1e-6;
 46. matern_estimate_shape on sim_vecchia (n = 100,000, m = 20, 42 M
     kernel entries), float64, on the device L-BFGS with maxit 2: the
     fit's seconds, NLL-and-gradient evaluations, host syncs an
     evaluation (bessel_kv's reads among them) and peak memory, one
     evaluation timed alone beside its byte bound; bessel_kv on the card
     against scipy.special.kv (values) and kvp (the x-gradient) on the
     JAX test's grid to 1e-10 relative; NLL and gradient card against
     CPU at n = 2,000 (1e-9, 1e-7);
 47. the covariance breadth card against CPU at n = 500, float64: each of
     the 14 kernels and ar1_mf_exponential on the dense engine, hurst,
     linear and ar1_mf_exponential (vecchia_euclidean) on the Vecchia
     engine, gaussian_ard on the tapering adapter and matern_ard on FITC:
     NLL and gradient (1e-10 and 1e-8; the Bessel kernels 1e-9 and 1e-7),
     the last two's predictions (1e-8); a two-iteration bernoulli_probit
     fit with ar1_mf_exponential (iterations equal, parameters 1e-6); the
     golden TestVecchiaAnisotropic::test_ard_full_neighbors_equals_dense
     on the card. Budget for 45-47: 75 s;
 48. the tree learner's split breadth on sim_tabular at boosting_n200k_p50's
     shape (n = 200,000, p = 50: 10 categorical columns of 5-500 levels, 10
     with 20 % NaN, 10 dense with monotone +1, +1, -1 on three, 20 sparse
     that EFB bundles into one int32 column of 5,101 bins): 20 rounds at
     31 leaves, 10 at 255, 10 with path_smooth, interaction constraints and
     the coupled, split and lazy CEGB penalties, 10 with extra trees and
     forced splits; for each, seconds a round, the host syncs of a tree
     (must be 1 + 1 a split + 2), the device busy share of two more
     rounds, B1's launches by route (the int32, two-window route must be
     taken), R^2 on 10,000 rows (above 0.1); categorical, missing-value and
     bundle splits must all occur; pred_leaf and pred_contrib on 10,000
     rows, whose rows must sum to the raw prediction to 1e-6;
 49. GPBoost with a grouped random intercept (n = 100,000, q = 1,000) on
     such columns, 10 rounds: seconds a round, host syncs of a tree,
     1,000 predictions with unseen groups' variances above the seen ones';
 50. card against CPU at n = 2,000, 3 rounds each of phase 48's 31-leaf,
     options and extra-trees models: each node's feature, bin, category
     set and (where a missing row reaches it) direction equal, or the
     first difference a float32 near tie; else leaf values, predictions
     and pred_contrib to 1e-6 and pred_leaf exactly; then B1 at B = 5,121
     (int32 codes, two bin windows) at n = 200,000, p = 31: bitwise to its
     emulation across launches and segment forms, whole and half
     segments, under a row permutation, against the plain version (1e-5
     of the largest entry), with its times. Budget for 48-50: 40 s.
 51. the booster's modes on boosting_n200k_p50 (sim_boost, n = 200,000,
     p = 50, 31 leaves, learning rate 0.1): plain gbdt, DART (drop_rate
     0.1, max_drop 50, skip_drop 0.5) and GOSS (top_rate 0.2, other_rate
     0.1, 10 of its rounds past the warm-up) 20 rounds each, a random
     forest (bagging 0.632 every round, feature_fraction 0.8) of 20 trees,
     linear trees 10 rounds; refit of the gbdt model on a second draw of
     200,000 rows. For each: seconds a round, the host syncs of a round
     (each tree 1 + 1 a split + 2, linear leaves one more read), the
     device busy share of two more rounds, B1's launches (> 0), R^2 on
     10,000 held-out rows (> 0.1); DART must drop a tree, the forest's
     training score must be its trees' mean to 1e-10;
 52. the multi-output and ranking objectives: multiclass (K = 5) on
     sim_boost's features, 10 rounds (50 trees), multi_logloss on 20,000
     validation rows, pred_contrib on 10,000 rows (blocks sum to the raw
     scores to 1e-6) and pred_early_stop (class decisions kept on 99 % of
     the rows); mean_scale_regression (friedman3's f with noise of a
     varying sd; the variance must follow it) and Grabit (tobit, yl 3.5,
     yu 4.8) on friedman3 (tests/test_grabit_meanscale.py) at n = 200,000,
     10 rounds;
     lambdarank and rank_xendcg at MSLR-WEB10K's widths (136 features of
     200 levels, relevance 0-4, queries of 40-200 documents; 200,000
     documents, the published set's ~1.2 M cut), 10 rounds with ndcg@10 on
     20,000 validation documents, the gradients' device time beside the
     numpy version's (equal to 1e-12). The numbers of phase 51 for each;
 53. card against CPU at n = 2,000, 3 rounds of each of the nine models
     (DART 5, GOSS 12): nodes equal or the first difference a float32 near
     tie, else leaf values, slopes, training score and predictions to
     1e-6; DART's drop sets and the GOSS and forest row masks equal; the
     ranking gradients at one score to 1e-12. Budget for 51-53: 45 s.
Every histogram row's library time is one torch.Tensor.index_add_ over the
flat key f * B + bin (key and expanded float32 values built outside the
timed window, sums held to the kernel's to 1e-5 of the largest entry);
the port never calls it.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import shutil
import tempfile
import time
import types

import numpy as np

SEED = 1
N_FULL, N_CPU, P, ROUNDS, N_PRED = 10_000, 2_000, 5, 10, 1_000
PARAMS = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 31,
          "verbose": 0}
# boosting_n200k_p50 (bench.py:302-327): plain boosting, no GP model
# ROUNDS_MODE: 3 since phases 48-50 came (was 5)
N_BOOST, P_BOOST, SEED_BOOST, ROUNDS_BOOST, ROUNDS_MODE = 200_000, 50, 2, 20, 3
N_RAGGED, N_TWO_RANKS = 123_457, 20_000
BOOST = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 31,
         "verbose": 0}
# the grouped-random-effects slice: examples/03_gpboost_algorithm.py at the
# GLMM bench's scale (bench.py:131-138), and its card-vs-CPU size
N_GROUPED, Q_GROUPED, P_GROUPED, N_GROUPED_CPU, Q_GROUPED_CPU = \
    100_000, 1_000, 6, 2_000, 50
GROUPED = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 31,
           "min_data_in_leaf": 20, "verbose": 0}
# the headline Vecchia fit (bench.py:231-245)
N_VECCHIA, MAXIT_VECCHIA = 100_000, 30
# the Laplace slice: bench.py's grouped_glmm (bench.py:131-138, :260-276)
# and examples/04_non_gaussian.py's LaGaBoost at the same scale
N_GLMM, Q_GLMM, SEED_GLMM, MAXIT_GLMM = 100_000, 1_000, 5, 50
Q_GLMM2 = 100
N_LAGA, Q_LAGA, P_LAGA, SEED_LAGA, N_LAGA_CPU, Q_LAGA_CPU = \
    100_000, 1_000, 5, 10, 2_000, 50
LAGA = {"learning_rate": 0.1, "num_leaves": 15, "verbose": 0}
# the Vecchia-Laplace slice: bench.py's vecchia_laplace_n20k (bench.py:
# 278-300) and its binary Vecchia LaGaBoost at the JAX bench's n = 20,000
# (bench.py:329-361)
N_VL, M_VL, SEED_VL, MAXIT_VL, N_VL_CPU = 20_000, 20, 3, 20, 1_000
P_VLB, SEED_VLB = 5, 4
VL_MODEL = {"cov_function": "exponential", "gp_approx": "vecchia",
            "num_neighbors": M_VL, "likelihood": "bernoulli_probit",
            "matrix_inversion_method": "cholesky"}
VL_FIT = {"maxit": MAXIT_VL, "init_cov_pars": [1.0, 0.1]}
VLB = {"objective": "binary", "learning_rate": 0.1, "num_leaves": 31,
       "verbose": 0}
ROUNDS_VL_DENSE = 1
# the iterative slice: the reference's iterative vecchia_laplace_n20k
# (bench_reference.py:229-236), its binary Vecchia LaGaBoost at n = 50,000
# (bench_reference.py:90-99, :190-203) and the grouped iterative branch
VL_ITER = {**VL_MODEL, "matrix_inversion_method": "iterative"}
N_VLB_ITER, MAXIT_VLB_ITER = 50_000, 5
# phase 24's float32 fit (3 iterations before phases 45-47 came)
MAXIT_VL32 = 1
# phase 26's card against CPU, whose CPU side is most of the phase
N_IT_CPU = 500
N_GROUPED_ITER, Q_GROUPED_ITER = 100_000, 25_000
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def sim_gpboost(n, p=P, seed=SEED):
    """bench.py sim_gpboost: spatial GP-like effect + nonlinear trees part."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, p)
    f = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    b = np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    return coords, X, f + b + 0.3 * rng.randn(n)


def sim_boost(n=N_BOOST, p=P_BOOST, seed=SEED_BOOST):
    """bench.py sim_boost: the boosting-only benchmark's data."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, p)
    y = X[:, 0] * 2 + np.sin(5 * X[:, 1]) + X[:, 2] * X[:, 3] \
        + 0.5 * rng.randn(n)
    return X, y


def sim_grouped(n, q, p=P_GROUPED, seed=SEED):
    """examples/03_gpboost_algorithm.py:19-25 with n rows and q groups."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, p)
    F = 2 * X[:, 0] + 2 * np.sin(8 * X[:, 1]) + (X[:, 2] > 0.6)
    group = rng.randint(0, q, n)
    b = 0.8 * rng.randn(q)
    return X, group, F + b[group] + 0.3 * rng.randn(n)


def sim_vecchia(n, seed=0):
    """bench.py sim_vecchia: a smooth spatial field plus noise."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    y = np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1]) \
        + 0.5 * rng.randn(n)
    return coords, y


def lcg_unif(n, init_c):
    """The LCG of the R suite's GPBoost tests (test_z_GPBoost_algorithm.R:27,
    tests/test_gpboost_algorithm_golden.py sim_rand_unif)."""
    mod = 134456
    out = np.empty(n)
    s = np.floor(init_c * mod)
    out[0] = s
    for i in range(1, n):
        s = (8121 * s + 28411) % mod
        out[i] = s
    return out / mod


def bound(nbytes, nops):
    """(bound_ms, bound_by): the least time for nbytes moved and nops
    float32 operations at the card's published peaks."""
    tb, to = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def new_points(n, p=P, seed=SEED + 1):
    rng = np.random.RandomState(seed)
    return rng.rand(n, p), rng.rand(n, 2)


# the card's name and power limit as nvidia-smi reports them (phase 1)
CARD = None


def phase_device(torch):
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the GPU "
                           "only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    CARD = card
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build(histogram):
    t0 = time.perf_counter()
    built = histogram.build()
    for name, (path, secs, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"[build] {name}: {os.path.relpath(path)} in {secs:.2f} s; "
              + " | ".join(ptxas), flush=True)
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)


def _time_ms(torch, fn, reps=25):
    """Median time of fn() in ms over reps calls, by CUDA events around
    each call: the wrapper's host work is inside it where the device waits
    for the host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_ms(torch, fn, reps=25, kernel="hist_"):
    """The kernel's own device time in ms per call of fn(), which launches
    one kernel whose name holds `kernel`: the mean duration of those
    kernels under torch.profiler over reps calls. The trace drops some
    calls' kernels (0-25 of 25 seen, most after phase 24's trace); one
    with fewer than 5 prints what it held, and a second trace is taken;
    None when neither has 5."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if str(e.device_type).endswith("CUDA")]
        spans = [e.time_range.end - e.time_range.start for e in dev
                 if kernel in e.name]
        if len(spans) >= 5:
            return sum(spans) * 1e-3 / len(spans)
        names = sorted({e.name[:50] for e in dev})
        print(f"[profiler] trace {attempt + 1} holds {len(spans)} '{kernel}' "
              f"kernels for {reps} calls: "
              f"{len(events)} events, {len(dev)} on the device "
              f"({names[:6]}), host events naming it "
              f"{sum(kernel in e.name for e in events)}", flush=True)
    return None


def _fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _library_ms(torch, key, vals, p, num_bins, kernel_out):
    """A histogram kernel's library time: one torch.Tensor.index_add_ of
    the float32 values vals (m, 3) into a zeroed (p * B, 3) tensor at the
    flat keys key = f * B + bin (m,), both built by the caller outside the
    timed window (median of 25 CUDA-event timings). Its sums are held to
    the kernel's output kernel_out (p, 3, B) to 1e-5 of the largest entry
    (float32 atomics in another order). The port never calls it."""
    def call():
        return torch.zeros((p * num_bins, 3), dtype=torch.float32,
                           device=key.device).index_add_(0, key, vals)
    lib = call().reshape(p, num_bins, 3).permute(0, 2, 1)
    err = float((lib - kernel_out).abs().max())
    scale = float(kernel_out.abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"index_add_ histogram: max |diff| {err:.3g} "
                             f"from the kernel's (largest entry "
                             f"{scale:.3g})")
    return _time_ms(torch, call)


def _segment_library_ms(torch, bins, stats, s0, cnt, num_bins, kernel_out):
    """_library_ms of hist_segment's rows [s0, s0 + cnt) of row-major bins
    (n, p) and stats (n, 3)."""
    b = bins[s0:s0 + cnt].long()
    p = b.shape[1]
    key = (b + torch.arange(p, device=b.device) * num_bins).reshape(-1)
    vals = stats[s0:s0 + cnt, None, :].expand(cnt, p, 3).reshape(-1, 3)
    return _library_ms(torch, key, vals.contiguous(), p, num_bins,
                       kernel_out)


def _feature_major_library_ms(torch, bins_T, stats_T, num_bins, kernel_out):
    """_library_ms of every row of feature-major bins (p, n) with stats
    (3, n) (a mask multiplied into them beforehand)."""
    p, n = bins_T.shape
    key = (bins_T.long() + torch.arange(p, device=bins_T.device)[:, None]
           * num_bins).reshape(-1)
    vals = stats_T.T[None].expand(p, n, 3).reshape(-1, 3).contiguous()
    return _library_ms(torch, key, vals, p, num_bins, kernel_out)


def _check_exact(torch, name, k1, k2, emu, ref, tol):
    """Kernel result k1 against a second launch k2 and the fixed-point
    emulation emu (both bitwise), and against the plain version ref:
    counts exact, grad/hess within tol (absolute). Returns the error."""
    if not torch.equal(k1, k2):
        raise AssertionError(f"{name}: two launches differ")
    if not torch.equal(k1, emu):
        d = float((k1 - emu).abs().max())
        raise AssertionError(f"{name}: differs from its fixed-point "
                             f"emulation by {d:.3g}")
    if not torch.equal(k1[:, 2], ref[:, 2]):
        raise AssertionError(f"{name}: counts differ from the plain version")
    err = float((k1[:, :2] - ref[:, :2]).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: grad/hess error {err:.3g} > {tol:.3g}")
    return err


def _segment_case(torch, histogram, name, bins, stats, s0, cnt, num_bins,
                  tol, gen):
    """hist_segment on [s0, s0 + cnt): host ints and a device pair, twice
    each, against the emulation and the plain version, and bitwise under a
    permutation of the segment's rows. Returns the grad/hess error."""
    dev = bins.device
    seg = torch.tensor([s0, cnt], dtype=torch.int32, device=dev)
    emu = histogram.hist_segment_fixed_point_reference(bins, stats, s0, cnt,
                                                       num_bins)
    ref = histogram.hist_segment_plain(bins, stats, s0, cnt, num_bins)
    err = 0.0
    for args in ((s0, cnt), (seg, None),
                 (torch.tensor(s0, device=dev), torch.tensor(cnt, device=dev))):
        k1 = histogram.hist_segment(bins, stats, *args, num_bins)
        k2 = histogram.hist_segment(bins, stats, *args, num_bins)
        torch.cuda.synchronize()
        err = max(err, _check_exact(torch, name, k1, k2, emu, ref, tol))
    perm = s0 + torch.randperm(cnt, generator=gen).to(dev)
    pb, ps = bins.clone(), stats.clone()
    pb[s0:s0 + cnt] = bins[perm]
    ps[s0:s0 + cnt] = stats[perm]
    kp = histogram.hist_segment(pb, ps, s0, cnt, num_bins)
    torch.cuda.synchronize()
    if not torch.equal(kp, k1):
        raise AssertionError(f"{name}: a permutation of the rows changes "
                             "the bits")
    return err


def _one_bin(bins, axis):
    """bins with feature 0's rows all in bin 3 (the worst case for shared
    atomics): column 0 of (n, p), or row 0 of (p, n)."""
    b = bins.clone()
    if axis == 1:
        b[:, 0] = 3
    else:
        b[0] = 3
    return b


def phase_kernel(torch, gpt, histogram):
    """hist_segment against its emulation and plain version on the card at
    the GPBoost slice's shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False   # plain einsum in full f32
    _, X, y = sim_gpboost(N_FULL)
    ds = gpt.Dataset(X, label=y)
    ds.construct()
    num_bins = int(ds.num_bins)
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    gen = torch.Generator().manual_seed(SEED)
    stats = np.ones((N_FULL, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(N_FULL)
    stats[:, 1] = rng.rand(N_FULL) + 0.5
    stats_d = torch.as_tensor(stats, device=dev)
    bins_u8 = torch.as_tensor(ds.bins.astype(np.uint8), device=dev)
    bins_i32 = bins_u8.to(torch.int32)
    one_bin = _one_bin(bins_u8, 1)
    cases = [("uint8", bins_u8, 0, N_FULL), ("uint8", bins_u8, 1237, 4321),
             ("uint8", bins_u8, 500, 0), ("uint8", bins_u8, N_FULL - 1, 1),
             ("int32", bins_i32, 0, N_FULL), ("int32", bins_i32, 3, 7777),
             ("uint8 one-bin feature", one_bin, 0, N_FULL)]
    max_err = 0.0
    for name, bins, s0, cnt in cases:
        # f32 sums of order-one values over <= 10k rows, in another order
        max_err = max(max_err, _segment_case(
            torch, histogram, f"hist_segment {name} [{s0},+{cnt})", bins,
            stats_d, s0, cnt, num_bins, 1e-4, gen))
        print(f"[kernel] {name} bins, segment [{s0}, {s0 + cnt}): ok",
              flush=True)
    amax = histogram.stat_amax(stats_d, 0)

    def kernel(b=bins_u8):
        return histogram.hist_segment(b, stats_d, 0, N_FULL, num_bins,
                                      amax=amax)
    t = dict(ms=_time_ms(torch, kernel), device_ms=_device_ms(torch, kernel),
             plain_ms=_time_ms(torch, lambda: histogram.hist_segment_plain(
                 bins_u8, stats_d, 0, N_FULL, num_bins)))
    one_ms = _device_ms(torch, lambda: kernel(one_bin))
    # each input read once (uint8 codes, three f32 stats), output written
    # once; 3 adds per row and feature
    t["bound_ms"], t["bound_by"] = bound(
        N_FULL * P + 12 * N_FULL + 12 * P * num_bins, 3 * N_FULL * P)
    t["library_ms"] = _segment_library_ms(torch, bins_u8, stats_d, 0,
                                          N_FULL, num_bins, kernel())
    print(f"[kernel] hist_segment n={N_FULL} p={P} B={num_bins} uint8: "
          f"kernel {t['ms']:.4f} ms by events, {_fmt_ms(t['device_ms'])} "
          f"device; plain einsum {t['plain_ms']:.4f} ms; index_add_ "
          f"{t['library_ms']:.4f} ms; bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']}); feature 0 in one bin "
          f"{_fmt_ms(one_ms)} device; max |err| {max_err:.3g}", flush=True)
    return {"name": "hist_segment", "route": "cuda",
            "source": "gpboost_tpu_torch/csrc/histogram.cu",
            "replaces": "gpboost_tpu/ops/histogram.py:85",
            "max_abs_err": max_err, **t}


def phase_segment_large(torch, histogram, ds, kernel_row):
    """hist_segment at the serial learner's shapes of boosting_n200k_p50
    (n = 200,000, p = 50, uint8): whole and half segment, and a feature in
    one bin. Adds the whole segment's times to kernel_row under
    "at_n200k"."""
    dev = torch.device("cuda")
    num_bins = int(ds.num_bins)
    n, p = ds.bins.shape
    rng = np.random.RandomState(SEED_BOOST)
    gen = torch.Generator().manual_seed(SEED_BOOST)
    stats = np.ones((n, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(n)
    stats[:, 1] = rng.rand(n) + 0.5
    stats_d = torch.as_tensor(stats, device=dev)
    bins = torch.as_tensor(np.ascontiguousarray(ds.bins, dtype=np.uint8),
                           device=dev)
    one_bin = _one_bin(bins, 1)
    half = n // 2
    for name, b, s0, cnt in (("whole", bins, 0, n), ("half", bins, 777, half),
                             ("one-bin feature", one_bin, 0, n)):
        # f32 sums of up to ~1,000 order-one values a bin in another order
        tol = 1e-5 * float(histogram.hist_segment_plain(
            b, stats_d, s0, cnt, num_bins)[:, :2].abs().max())
        _segment_case(torch, histogram, f"hist_segment n={n} {name}", b,
                      stats_d, s0, cnt, num_bins, max(tol, 1e-5), gen)
    amax = histogram.stat_amax(stats_d, 0)
    res = {}
    for name, b, s0, cnt in (("whole", bins, 0, n), ("half", bins, 777, half),
                             ("one-bin feature", one_bin, 0, n)):
        def kernel():
            return histogram.hist_segment(b, stats_d, s0, cnt, num_bins,
                                          amax=amax)
        res[name] = (_time_ms(torch, kernel), _device_ms(torch, kernel))
    bound_ms, bound_by = bound(n * p + 12 * n + 12 * p * num_bins, 3 * n * p)
    plain_ms = _time_ms(torch, lambda: histogram.hist_segment_plain(
        bins, stats_d, 0, n, num_bins), reps=10)
    library_ms = _segment_library_ms(
        torch, bins, stats_d, 0, n, num_bins, histogram.hist_segment(
            bins, stats_d, 0, n, num_bins, amax=amax))
    print(f"[kernel] hist_segment n={n} p={p} B={num_bins} uint8: "
          + "; ".join(f"{k} {v[0]:.4f} ms by events, {_fmt_ms(v[1])} device"
                      for k, v in res.items())
          + f"; plain (whole) {plain_ms:.4f} ms; index_add_ (whole) "
          f"{library_ms:.4f} ms; bound (whole) {bound_ms:.5f} ms "
          f"({bound_by})", flush=True)
    kernel_row["at_n200k_p50"] = {
        "ms": res["whole"][0], "device_ms": res["whole"][1],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "half_ms": res["half"][0],
        "half_device_ms": res["half"][1]}


def _train(torch, gpt, n, dtype, device, params=PARAMS, rounds=ROUNDS):
    """The slice: returns (booster, gp, initial-fit seconds, train seconds)."""
    coords, X, y = sim_gpboost(n)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20, dtype=dtype,
                     device=device)
    fit_secs = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        fit_secs.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    t0 = time.perf_counter()
    bst = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=rounds,
                    gp_model=gp, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return bst, gp, fit_secs[0], time.perf_counter() - t0


def phase_slice(torch, gpt, histogram):
    """w_gpboost1000 at full width for 10 rounds on the card, then predict."""
    _reset_launches(histogram)
    bst, gp, fit_s, train_s = _train(torch, gpt, N_FULL, "float32", "cuda")
    Xn, cn = new_points(N_PRED)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    launches = histogram.hist_segment.launches
    cov = gp.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"covariance parameters {cov}")
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"prediction {k} not finite / wrong shape")
    if len(bst.trees) != ROUNDS or launches <= 0:
        raise AssertionError(f"{len(bst.trees)} trees, {launches} kernel "
                             "launches")
    print(f"[slice] n={N_FULL} m=20 float32, {ROUNDS} rounds: initial GP fit "
          f"{fit_s:.3f} s, mean per round {(train_s - fit_s) / ROUNDS:.4f} s "
          f"(train {train_s:.3f} s incl. the fit), predict {N_PRED} points "
          f"{pred_s:.3f} s; cov pars {cov.tolist()}; hist_segment launches "
          f"{launches}", flush=True)
    return launches


def _reset_launches(histogram):
    for fn in (histogram.hist_segment, histogram.hist_masked,
               histogram.hist_block):
        fn.launches = 0
    histogram.hist_segment.routes.clear()


def _split_records(tree):
    internal = np.flatnonzero(~tree.is_leaf[:tree.num_nodes])
    return [(int(i), int(tree.split_feature[i]), int(tree.threshold_bin[i]),
             float(tree.split_gain[i])) for i in internal]


def phase_card_vs_cpu(torch, gpt):
    """The slice at n = 2,000 in float64: card (kernel) against CPU (plain)."""
    runs = {dev: _train(torch, gpt, N_CPU, "float64", dev)
            for dev in ("cuda", "cpu")}
    (bg, gg, _, tg), (bc, gc, _, tc) = runs["cuda"], runs["cpu"]
    rg, rc = _split_records(bg.trees[0]), _split_records(bc.trees[0])
    if [r[:3] for r in rg] != [r[:3] for r in rc]:
        i = next(k for k, (a, b) in enumerate(zip(rg, rc)) if a[:3] != b[:3])
        gap = abs(rg[i][3] - rc[i][3]) / max(abs(rc[i][3]), 1e-30)
        print(f"[card-vs-cpu] first tree: split {i} differs: card {rg[i]} "
              f"cpu {rc[i]}, relative gain gap {gap:.3g}", flush=True)
        if not gap < 1e-5:
            raise AssertionError("first-tree splits differ beyond an f32 "
                                 "near-tie")
    else:
        print(f"[card-vs-cpu] first tree: all {len(rg)} split records equal",
              flush=True)
    cg, cc = gg.get_cov_pars(), gc.get_cov_pars()
    # f32 histogram sums in another order move leaf values by ~1e-7 and the
    # refitted float64 covariance parameters by far less than 1e-4
    cov_rel = float(np.max(np.abs(cg / cc - 1.0)))
    if not cov_rel < 1e-4:
        raise AssertionError(f"cov pars card {cg} cpu {cc}")
    Xn, cn = new_points(200)
    pg = bg.predict(Xn, gp_coords_pred=cn)["response_mean"]
    pc = bc.predict(Xn, gp_coords_pred=cn)["response_mean"]
    # trees agree to f32 rounding of their leaf values (~1e-7 x 10 rounds)
    pred_err = float(np.max(np.abs(pg - pc)))
    if not pred_err < 1e-4:
        raise AssertionError(f"predictions differ by {pred_err}")
    print(f"[card-vs-cpu] n={N_CPU} float64 {ROUNDS} rounds: cov pars "
          f"max rel diff {cov_rel:.3g} (card {cg.tolist()}), predictions max "
          f"|diff| {pred_err:.3g}; train card {tg:.3f} s, cpu {tc:.3f} s",
          flush=True)


def phase_masked_kernels(torch, histogram, ds):
    """hist_masked and hist_block against their fixed-point emulation
    (bitwise) and their plain versions on the card at the boosting slice's
    shapes."""
    dev = torch.device("cuda")
    num_bins = int(ds.num_bins)
    n, p = ds.bins.shape
    rng = np.random.RandomState(SEED_BOOST)
    stats = np.ones((3, n), dtype=np.float32)
    stats[0] = rng.randn(n)
    stats[1] = rng.rand(n) + 0.5
    node_np = rng.randint(0, 2, size=n).astype(np.int32)
    node_np[12345] = 7                           # a one-row selection
    stats_d = torch.as_tensor(stats, device=dev)
    node_d = torch.as_tensor(node_np, device=dev)
    bins_u8 = torch.as_tensor(np.ascontiguousarray(ds.bins.T, dtype=np.uint8),
                              device=dev)
    bins_i32 = bins_u8.to(torch.int32)
    one_bin = _one_bin(bins_u8, 0)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        SEED_BOOST)).to(dev)
    err = {"hist_masked": 0.0, "hist_block": 0.0}

    def check(name, fn, emu_fn, ref_fn, args, perm_args):
        k1, k2 = fn(*args), fn(*args)
        emu, ref = emu_fn(*args), ref_fn(*args)
        kp = fn(*perm_args)
        torch.cuda.synchronize()
        # f32 sums of up to ~1,000 order-one values a bin, in another
        # order: a few hundred ulps of the largest entry at most
        tol = 1e-5 * max(1.0, float(ref[:, :2].abs().max()))
        e = _check_exact(torch, name, k1, k2, emu, ref, tol)
        if not torch.equal(kp, k1):
            raise AssertionError(f"{name}: a permutation of the rows changes "
                                 "the bits")
        return k1, e

    for bname, bins in (("uint8", bins_u8), ("int32", bins_i32),
                        ("uint8 one-bin feature", one_bin)):
        for m in (n, N_RAGGED):
            b = bins[:, :m].contiguous()
            s = stats_d[:, :m].contiguous()
            nd = node_d[:m].contiguous()
            pm = perm[perm < m]
            bp, sp, ndp = b[:, pm].contiguous(), s[:, pm].contiguous(), \
                nd[pm].contiguous()
            for target in (1, 5, 7, torch.tensor(1, device=dev)):
                tname = "device 1" if isinstance(target, torch.Tensor) \
                    else str(target)
                k1, e = check(f"hist_masked {bname} n={m} target {tname}",
                              histogram.hist_masked,
                              histogram.hist_masked_fixed_point_reference,
                              histogram.hist_masked_plain,
                              (b, nd, s, target, num_bins),
                              (bp, ndp, sp, target, num_bins))
                if target == 5 and k1.any():
                    raise AssertionError("hist_masked: an empty target "
                                         "gave a non-zero histogram")
                if target == 7 and float(k1[0, 2].sum()) != 1.0:
                    raise AssertionError("hist_masked: a one-row target "
                                         "did not count one row")
                err["hist_masked"] = max(err["hist_masked"], e)
            sm = s * (nd == 1).to(torch.float32)[None, :]
            smp = sp * (ndp == 1).to(torch.float32)[None, :]
            _, e = check(f"hist_block {bname} n={m}", histogram.hist_block,
                         histogram.hist_block_fixed_point_reference,
                         histogram.hist_block_plain, (b, sm, num_bins),
                         (bp, smp, num_bins))
            err["hist_block"] = max(err["hist_block"], e)
            print(f"[kernel] hist_masked, hist_block {bname} bins n={m} "
                  f"p={p} B={num_bins}: ok", flush=True)
    # a non-finite stat: that channel is NaN in every bin, the others exact
    bad = stats_d.clone()
    bad[0, 99] = float("nan")
    k = histogram.hist_masked(bins_u8, node_d, bad, 1, num_bins)
    emu = histogram.hist_masked_fixed_point_reference(bins_u8, node_d, bad,
                                                      1, num_bins)
    torch.cuda.synchronize()
    if not (bool(torch.isnan(k[:, 0]).all())
            and torch.equal(k[:, 1:], emu[:, 1:])):
        raise AssertionError("hist_masked: a NaN grad did not give a NaN "
                             "grad channel and exact other channels")
    print("[kernel] hist_masked with a NaN grad: grad channel NaN in every "
          "bin, hess and count bitwise equal to the emulation", flush=True)

    sel = int(np.sum(node_np == 1))
    out_bytes = 12 * p * num_bins
    amax = histogram.stat_amax(stats_d, 1)

    def times(fn, plain):
        return dict(ms=_time_ms(torch, fn), device_ms=_device_ms(torch, fn),
                    plain_ms=_time_ms(torch, plain))
    masked = times(lambda: histogram.hist_masked(
        bins_u8, node_d, stats_d, 1, num_bins, amax=amax),
        lambda: histogram.hist_masked_plain(bins_u8, node_d, stats_d, 1,
                                            num_bins))
    # the least a masked scan must move: every node id, the bin codes and
    # stats of the selected rows only, the output; 3 adds per selected row
    # and feature
    masked["bound_ms"], masked["bound_by"] = bound(
        4 * n + sel * (p + 12) + out_bytes, 3 * sel * p)
    block = times(lambda: histogram.hist_block(bins_u8, stats_d, num_bins,
                                               amax=amax),
                  lambda: histogram.hist_block_plain(bins_u8, stats_d,
                                                     num_bins))
    block["bound_ms"], block["bound_by"] = bound(
        n * p + 12 * n + out_bytes, 3 * n * p)
    # index_add_ over every row; the mask multiplied into the stats outside
    # the timed window
    masked["library_ms"] = _feature_major_library_ms(
        torch, bins_u8, stats_d * (node_d == 1).to(torch.float32)[None, :],
        num_bins, histogram.hist_masked(bins_u8, node_d, stats_d, 1,
                                        num_bins, amax=amax))
    block["library_ms"] = _feature_major_library_ms(
        torch, bins_u8, stats_d, num_bins,
        histogram.hist_block(bins_u8, stats_d, num_bins, amax=amax))
    extra = {
        "hist_masked": _device_ms(torch, lambda: histogram.hist_masked(
            one_bin, node_d, stats_d, 1, num_bins, amax=amax)),
        "hist_block": _device_ms(torch, lambda: histogram.hist_block(
            one_bin, stats_d, num_bins, amax=amax))}
    out = []
    for name, t in (("hist_masked", masked), ("hist_block", block)):
        print(f"[kernel] {name} n={n} p={p} B={num_bins} uint8"
              + (f" ({sel} rows selected)" if name == "hist_masked" else "")
              + f": kernel {t['ms']:.4f} ms by events, "
              f"{_fmt_ms(t['device_ms'])} device; plain einsum "
              f"{t['plain_ms']:.4f} ms; index_add_ {t['library_ms']:.4f} "
              f"ms; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); feature 0 in one bin "
              f"{_fmt_ms(extra[name])} device; max |err| {err[name]:.3g}",
              flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": "gpboost_tpu_torch/csrc/hist_masked.cu",
                    "replaces": ("gpboost_tpu/ops/histogram.py:155"
                                 if name == "hist_masked" else
                                 "gpboost_tpu/ops/histogram.py:129"),
                    "max_abs_err": err[name], **t})
    return out


def _threshold_ties(what, ref_trees, other_trees, first=0):
    """The split records of tree pairs grown from the same gradients,
    equal but for ties: a threshold moved at equal float32 gains (the same
    node and feature: both cut the node's rows alike, and only new rows
    between them go another way), or, ending that tree's comparison, a
    near tie of phase 5's rule (a relative gain gap below 1e-5, which
    splits the rows otherwise). Returns (moved: [(tree, node, feature, ref
    threshold, other threshold)], the number of near ties); `first` is
    the first pair's tree index."""
    moved, near = [], 0
    for t, (a, b) in enumerate(zip(ref_trees, other_trees), first):
        ra, rb = _split_records(a), _split_records(b)
        for u, v in zip(ra, rb):
            if u[:3] == v[:3]:
                continue
            print(f"[{what}] tree {t} split differs: {u} vs {v}", flush=True)
            if u[:2] == v[:2] and u[3] == v[3]:
                moved.append((t, u[0], u[1], float(a.threshold_real[u[0]]),
                              float(b.threshold_real[v[0]])))
                continue
            if not abs(u[3] - v[3]) / max(abs(u[3]), 1e-30) < 1e-5:
                raise AssertionError(f"{what}: tree {t} differs beyond a "
                                     "near tie")
            near += 1
            break
        else:
            if len(ra) != len(rb):
                raise AssertionError(f"{what}: tree {t} has {len(rb)} "
                                     f"splits, not {len(ra)}")
    return moved, near


def _compare_models(what, ref, other, X=None):
    """Split records of every tree equal, or the first difference a float32
    near-tie (phase 5's rule; later trees are then not compared); with X,
    predictions to 1e-5 when every split is equal."""
    for t, (a, b) in enumerate(zip(ref.trees, other.trees)):
        ra, rb = _split_records(a), _split_records(b)
        if [r[:3] for r in ra] == [r[:3] for r in rb]:
            continue
        i = next((k for k, (u, v) in enumerate(zip(ra, rb))
                  if u[:3] != v[:3]), min(len(ra), len(rb)))
        if i >= min(len(ra), len(rb)):
            raise AssertionError(f"{what}: tree {t} has {len(rb)} splits, "
                                 f"not {len(ra)}")
        gap = abs(ra[i][3] - rb[i][3]) / max(abs(ra[i][3]), 1e-30)
        print(f"[{what}] tree {t} split {i} differs: {ra[i]} vs {rb[i]}, "
              f"relative gain gap {gap:.3g}", flush=True)
        if not gap < 1e-5:
            raise AssertionError(f"{what}: splits differ beyond an f32 "
                                 "near-tie")
        return "near tie"
    if X is not None:
        k = len(other.trees)
        pa = sum(tr.predict_raw(X) for tr in ref.trees[:k]) + ref.init_score
        pb = other.predict(X)
        d = float(np.max(np.abs(pa - pb)))
        if not d <= 1e-5:
            raise AssertionError(f"{what}: predictions differ by {d:.3g}")
        return f"all splits equal, predictions max |diff| {d:.3g}"
    return "all splits equal"


def _card_cpu_boosters(what, bc, bg, gc, gg, Xn, pred_kw):
    """Card against CPU for two boosters (phases 12 and 29): trees under
    phase 5's near-tie rule, covariance parameters to rtol 1e-4, and to
    1e-4 the training score, the trees before a near tie and the
    predictions. A near tie moves a threshold, and so the fixed effect of
    new rows from that tree on: after one only the random part is
    compared."""
    res = _compare_models(what, bc, bg)
    cg, cc = gg.get_cov_pars(), gc.get_cov_pars()
    cov_rel = float(np.max(np.abs(cg / cc - 1.0)))
    if not cov_rel < 1e-4:
        raise AssertionError(f"{what}: cov pars card {cg} cpu {cc}")
    k = next((t for t, (a, b) in enumerate(zip(bc.trees, bg.trees))
              if [r[:3] for r in _split_records(a)]
              != [r[:3] for r in _split_records(b)]), len(bc.trees))
    pg = bg.predict(Xn, predict_var=True, **pred_kw)
    pc = bc.predict(Xn, predict_var=True, **pred_kw)
    keys = ("random_effect_mean", "response_var") if k < len(bc.trees) \
        else ("response_mean", "response_var")
    errs = {key: float(np.max(np.abs(pg[key] - pc[key]))) for key in keys}
    errs["training score"] = float((bg.F.cpu() - bc.F).abs().max())
    errs[f"fixed effect of trees 0-{k - 1}"] = float(np.max(np.abs(
        sum(t.predict_raw(Xn) for t in bg.trees[:k])
        - sum(t.predict_raw(Xn) for t in bc.trees[:k]))))
    if not max(errs.values()) < 1e-4:
        raise AssertionError(f"{what}: max |diff| {errs}")
    return (f"trees {res}; cov pars max rel diff {cov_rel:.3g}; max |diff| "
            + ", ".join(f"{key} {v:.3g}" for key, v in errs.items()))


def _device_busy_s(torch, fn, kernel="hist_", by_name=None, cpu=True):
    """(device busy seconds, wall seconds, seconds in device kernels whose
    name holds `kernel`) of fn() under torch.profiler: busy is the union of
    the device events' time spans, None when the profiler saw none. A
    given dict `by_name` gets the summed seconds of each device event
    name. cpu=False traces the device alone and reads the profiler's raw
    events, without building its event tree (a trace of two rounds of
    phase 42, with the host's ops, took 86 s to read that way)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if cpu:
        # (name, start, end) in seconds
        events = [(e.name, e.time_range.start * 1e-6,
                   e.time_range.end * 1e-6) for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
    else:
        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
        base = min((a for _, a, _ in raw), default=0)   # integer ns
        events = [(name, (a - base) * 1e-9, (b - base) * 1e-9)
                  for name, a, b in raw]
    if not events:
        return None, wall, None
    if by_name is not None:
        for name, a, b in events:
            by_name[name] = by_name.get(name, 0.0) + b - a
    mine = sum(b - a for name, a, b in events if kernel in name)
    spans = sorted((a, b) for _, a, b in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo, wall, mine


def _busy_txt(busy, wall, hist_s=None):
    if busy is None:
        return "not measured (no device events)"
    txt = f"{busy:.4f} s of {wall:.4f} s ({busy / wall:.1%})"
    if hist_s is None:
        return txt
    return txt + f", of which histogram kernels {hist_s:.4f} s"


def phase_parallel(torch, gpt, histogram, ds, X, y):
    """boosting_n200k_p50 on a one-rank NCCL group: the data learner for 20
    rounds (the path's run), the feature and voting learners for 5, the
    serial positional learner for 1; then the one-rank reference of phase
    8 at n = 20,000. Returns the launches of hist_masked and hist_block
    over the data learner's 20 rounds, hist_segment's over the serial
    round, and the reference booster."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            par = {**BOOST, "num_parallel_devices": 1}
            _reset_launches(histogram)
            t0 = time.perf_counter()
            bst = gpt.Booster({**par, "tree_learner": "data"}, ds,
                              device="cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            rounds = []
            for _ in range(ROUNDS_BOOST):
                t0 = time.perf_counter()
                bst.update()
                torch.cuda.synchronize()
                rounds.append(time.perf_counter() - t0)
            launches = histogram.hist_masked.launches
            block_launches = histogram.hist_block.launches
            if histogram.hist_segment.launches or launches <= 0:
                raise AssertionError(
                    f"data learner: {launches} hist_masked and "
                    f"{histogram.hist_segment.launches} hist_segment "
                    "launches")
            busy, wall, hist_s = _device_busy_s(
                torch, lambda: [bst.update() for _ in range(2)])
            pred = bst.predict(X)
            mse0 = float(np.mean((y - np.mean(y)) ** 2))
            mse = float(np.mean((y - pred) ** 2))
            if pred.shape != (len(y),) or not np.all(np.isfinite(pred)) \
                    or not mse < 0.8 * mse0:
                raise AssertionError(f"data learner: training MSE {mse:.4g} "
                                     f"(label variance {mse0:.4g})")
            busy_txt = _busy_txt(busy, wall, hist_s)
            print(f"[parallel] boosting_n200k_p50 data learner, 1 NCCL rank,"
                  f" {ROUNDS_BOOST} rounds: setup {setup_s:.3f} s, first "
                  f"round {rounds[0]:.4f} s, mean of rounds 2-"
                  f"{ROUNDS_BOOST} {np.mean(rounds[1:]):.4f} s (min "
                  f"{np.min(rounds[1:]):.4f}, max {np.max(rounds[1:]):.4f}); "
                  f"hist_masked launches {launches}; training MSE {mse:.4f} "
                  f"(label variance {mse0:.4f}); device busy over rounds "
                  f"{ROUNDS_BOOST + 1}-{ROUNDS_BOOST + 2}: {busy_txt}",
                  flush=True)
            for mode, extra in (("feature", {}), ("voting", {"top_k": 20})):
                t0 = time.perf_counter()
                other = gpt.train({**par, "tree_learner": mode, **extra}, ds,
                                  num_boost_round=ROUNDS_MODE, device="cuda")
                torch.cuda.synchronize()
                res = _compare_models(f"parallel {mode}", bst, other)
                print(f"[parallel] {mode} learner, 1 rank, {ROUNDS_MODE} "
                      f"rounds in {time.perf_counter() - t0:.3f} s against "
                      f"the data learner: {res}", flush=True)
            histogram.hist_segment.launches = 0
            serial = gpt.train(BOOST, ds, num_boost_round=1, device="cuda")
            segment_launches = histogram.hist_segment.launches
            if serial.learner.group is not None:
                raise AssertionError("serial learner ran on the group")
            print("[parallel] serial positional learner (hist_segment, "
                  f"{segment_launches} launches in its round), first tree "
                  "against the data learner's: "
                  + _compare_models("masked-vs-positional", bst, serial),
                  flush=True)
            X2, y2 = X[:N_TWO_RANKS], y[:N_TWO_RANKS]
            ref = gpt.train({**par, "tree_learner": "data"},
                            gpt.Dataset(X2, label=y2),
                            num_boost_round=ROUNDS_MODE, device="cuda")
        finally:
            dist.destroy_process_group()
    return launches, block_launches, segment_launches, ref


def phase_two_ranks(torch, gpt, X, y, ref):
    """spawn_train, 2 gloo ranks on one card, at n = 20,000: each learner
    against the one-rank data learner."""
    X2, y2 = X[:N_TWO_RANKS], y[:N_TWO_RANKS]
    modes = [("data", {}), ("feature", {}), ("voting", {"top_k": 25})]
    t0 = time.perf_counter()
    boosters = gpt.spawn_train(
        [{**BOOST, "tree_learner": m, **extra} for m, extra in modes], X2, y2,
        num_boost_round=ROUNDS_MODE, world_size=2, backend="gloo",
        device="cuda")
    secs = time.perf_counter() - t0
    for (mode, _), b in zip(modes, boosters):
        print(f"[two-ranks] {mode}: "
              + _compare_models(f"two-ranks {mode}", ref, b, X2), flush=True)
    print(f"[two-ranks] n={N_TWO_RANKS} p={P_BOOST}, 2 gloo ranks on one "
          f"card, {len(modes)} models x {ROUNDS_MODE} rounds: "
          f"{secs:.2f} s including the ranks' start", flush=True)


def _count_syncs(torch, fn, sites=None):
    """(fn(), host syncs): the synchronizing CUDA calls that torch's sync
    debug mode flags while fn runs (reads of device values, copies from
    pageable host memory, cuSOLVER info checks). A given Counter `sites`
    gets the Python line of each."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        sites.update(f"{os.path.relpath(w.filename)}:{w.lineno}"
                     for w in syncs)
    return out, len(syncs)


def phase_segment_grouped(torch, histogram, ds, kernel_row):
    """hist_segment at the grouped slice's shapes: n = 100,000 rows, the
    dataset's p = 6 features and its first 5, uint8, the real bin count;
    the checks of phase 3. Adds the times to kernel_row under
    "at_n100k_p6"."""
    dev = torch.device("cuda")
    num_bins = int(ds.num_bins)
    n, p = ds.bins.shape
    rng = np.random.RandomState(SEED)
    gen = torch.Generator().manual_seed(SEED)
    stats = np.ones((n, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(n)
    stats[:, 1] = rng.rand(n) + 0.5
    stats_d = torch.as_tensor(stats, device=dev)
    bins6 = torch.as_tensor(np.ascontiguousarray(ds.bins, dtype=np.uint8),
                            device=dev)
    bins5 = bins6[:, :5].contiguous()
    for name, b, s0, cnt in (("p=6 whole", bins6, 0, n),
                             ("p=6 part", bins6, 4321, 37_777),
                             ("p=5 whole", bins5, 0, n),
                             ("p=6 one-bin feature", _one_bin(bins6, 1), 0,
                              n)):
        tol = 1e-5 * float(histogram.hist_segment_plain(
            b, stats_d, s0, cnt, num_bins)[:, :2].abs().max())
        _segment_case(torch, histogram, f"hist_segment n={n} {name}", b,
                      stats_d, s0, cnt, num_bins, max(tol, 1e-5), gen)
    amax = histogram.stat_amax(stats_d, 0)
    row = {}
    for pp, b in ((6, bins6), (5, bins5)):
        def kernel():
            return histogram.hist_segment(b, stats_d, 0, n, num_bins,
                                          amax=amax)
        bound_ms, bound_by = bound(n * pp + 12 * n + 12 * pp * num_bins,
                                   3 * n * pp)
        row[f"p{pp}"] = {
            "ms": _time_ms(torch, kernel), "device_ms": _device_ms(
                torch, kernel),
            "plain_ms": _time_ms(torch, lambda: histogram.hist_segment_plain(
                b, stats_d, 0, n, num_bins)),
            "library_ms": _segment_library_ms(torch, b, stats_d, 0, n,
                                              num_bins, kernel()),
            "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[kernel] hist_segment n={n} B={num_bins} uint8, whole segment: "
          + "; ".join(f"{k}: {v['ms']:.4f} ms by events, "
                      f"{_fmt_ms(v['device_ms'])} device, plain "
                      f"{v['plain_ms']:.4f} ms, index_add_ "
                      f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.5f} "
                      "ms" for k, v in row.items()), flush=True)
    kernel_row["at_n100k_p6"] = row["p6"]
    kernel_row["at_n100k_p5"] = row["p5"]


def _grouped_new_rows(q, n_pred=N_PRED, seed=SEED + 2):
    """n_pred new rows, the first half in training groups, the second in
    groups never seen."""
    rng = np.random.RandomState(seed)
    Xn = rng.rand(n_pred, P_GROUPED)
    gn = np.concatenate([rng.randint(0, q, n_pred // 2),
                         q + rng.randint(0, 50, n_pred - n_pred // 2)])
    return Xn, gn


def _train_grouped(torch, gpt, n, q, device, rounds=ROUNDS, weights=None):
    """The grouped slice: (booster, gp, first-fit s, per-round s)."""
    X, group, y = sim_grouped(n, q)
    gp = gpt.GPModel(group_data=group, device=device, weights=weights)
    fit_secs = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        fit_secs.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    bst = gpt.Booster(GROUPED, gpt.Dataset(X, label=y), gp_model=gp,
                      device=device)
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        bst.update()
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs[0] -= fit_secs[0]
    return bst, gp, fit_secs[0], secs


def phase_grouped_slice(torch, gpt, histogram):
    """GPBoost with a grouped random intercept at full width (n = 100,000,
    q = 1,000, p = 6, float64) for 10 rounds, then predict 1,000 new rows,
    half of them in unseen groups. Returns hist_segment's launches."""
    _reset_launches(histogram)
    bst, gp, fit_s, secs = _train_grouped(torch, gpt, N_GROUPED, Q_GROUPED,
                                          "cuda")
    launches = histogram.hist_segment.launches
    # one steady round's host syncs, those of the tree counted apart
    from collections import Counter
    tree_syncs, sites = [], Counter()
    train = bst.learner.train

    def counted_train(*args, **kwargs):
        out, s = _count_syncs(torch, lambda: train(*args, **kwargs), sites)
        tree_syncs.append(s)
        return out

    bst.learner.train = counted_train
    _, syncs = _count_syncs(torch, bst.update, sites)
    bst.learner.train = train
    print("[grouped] host syncs of round 11 by Python line: " + ", ".join(
        f"{k} x{v}" for k, v in sites.most_common()), flush=True)
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)])
    Xn, gn = _grouped_new_rows(Q_GROUPED)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, group_data_pred=gn, predict_var=True)
    pred_s = time.perf_counter() - t0
    cov = gp.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"grouped slice: covariance parameters {cov}")
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"grouped slice: prediction {k}")
    var = pred["response_var"]
    half = N_PRED // 2
    # an unseen group adds the group variance to the predictive variance
    if not np.min(var[half:]) > np.max(var[:half]):
        raise AssertionError("grouped slice: unseen groups' variances are "
                             "not above the seen groups'")
    if launches <= 0:
        raise AssertionError(f"grouped slice: {launches} hist_segment "
                             "launches")
    print(f"[grouped] n={N_GROUPED} q={Q_GROUPED} p={P_GROUPED} float64, "
          f"{ROUNDS} rounds: first GP fit {fit_s:.3f} s "
          f"({gp.get_num_optim_iter()} iterations, "
          f"{gp._fit_result.optimizer}), mean per round {np.mean(secs):.4f} "
          f"s (min {np.min(secs):.4f}, max {np.max(secs):.4f}); host syncs "
          f"in round {ROUNDS + 1}: {syncs + tree_syncs[0]} ({tree_syncs[0]} "
          f"in the tree, {syncs} in the rest); device busy over rounds "
          f"{ROUNDS + 2}-{ROUNDS + 3}: {_busy_txt(busy, wall, hist_s)}; "
          f"predict {N_PRED} rows {pred_s:.3f} s; cov pars {cov.tolist()}; "
          f"hist_segment launches over the {ROUNDS} rounds {launches}",
          flush=True)
    return launches


def phase_grouped_goldens(torch, gpt):
    """The n = 100,000 grouped GPBoost goldens of the R suite
    (tests/test_gpboost_algorithm_golden.py TestLargeDataAndLineSearch) on
    the card, at that file's tolerances."""
    from scipy.stats import norm
    n = 100_000
    X = np.reshape(lcg_unif(2 * n, 0.135), (2, n)).T.copy()
    m = n // 100
    group = np.repeat(np.arange(1, m + 1), n // m).astype(float)
    b1 = np.sqrt(0.6) * norm.ppf(lcg_unif(m, 0.462))
    xi = 0.1 * norm.ppf(lcg_unif(n, 0.17556))
    xi[xi < -100] = 0
    y = b1[(group - 1).astype(int)] + xi
    opt = {"optimizer_cov": "gradient_descent", "lr_cov": 0.1,
           "use_nesterov_acc": True, "acc_rate_cov": 0.5,
           "delta_rel_conv": 1e-6, "optimizer_coef": "gradient_descent",
           "lr_coef": 0.1,
           "convergence_criterion": "relative_change_in_log_likelihood",
           "init_coef_aux_pars_from_iid_model": False}
    boost = {"learning_rate": 0.01, "max_depth": 6, "min_data_in_leaf": 5,
             "objective": "regression_l2", "verbose": 0}

    def run(label, lr, rounds, line_search):
        gp = gpt.GPModel(group_data=group, device="cuda")
        gp.set_optim_params(params=opt)
        t0 = time.perf_counter()
        gpt.train({**boost, "learning_rate": lr,
                   "line_search_step_length": line_search},
                  gpt.Dataset(X, label=label), num_boost_round=rounds,
                  gp_model=gp, device="cuda")
        torch.cuda.synchronize()
        return gp, time.perf_counter() - t0

    gp, secs = run(y, 0.01, 62, False)
    cp, nll = gp.get_cov_pars(), gp.get_current_neg_log_likelihood()
    if not (np.sum(np.abs(cp - [0.009426053798, 0.602785377299])) < 1e-3
            and abs(nll + 86930.9172156506) / 86930.9 < 1e-3):
        raise AssertionError(f"62-round golden: cov pars {cp}, nll {nll}")
    ycv = y + X @ np.array([1.0, 1.0])
    nlls = {ls: run(ycv, 0.5, 10, ls)[0].get_current_neg_log_likelihood()
            for ls in (False, True)}
    if not (abs(nlls[False] - 162232.5638) / 162232.6 < 0.05
            and abs(nlls[True] + 82056.84807) / 82056.8 < 0.005):
        raise AssertionError(f"line-search golden: nlls {nlls}")
    print(f"[grouped-goldens] n={n} q={m}: 62 rounds in {secs:.2f} s, cov "
          f"pars {cp.tolist()} (golden [0.009426, 0.602785]), nll {nll:.4f} "
          f"(golden -86930.9172); lr 0.5, 10 rounds: nll without line "
          f"search {nlls[False]:.2f} (golden 162232.56), with "
          f"{nlls[True]:.2f} (golden -82056.85)", flush=True)


def phase_grouped_card_vs_cpu(torch, gpt):
    """The grouped slice at the example's own size (n = 2,000, q = 50),
    float64: card against CPU."""
    runs = {dev: _train_grouped(torch, gpt, N_GROUPED_CPU, Q_GROUPED_CPU,
                                dev) for dev in ("cuda", "cpu")}
    (bg, gg, _, sg), (bc, gc, _, sc) = runs["cuda"], runs["cpu"]
    Xn, gn = _grouped_new_rows(Q_GROUPED_CPU, 200)
    txt = _card_cpu_boosters("grouped card-vs-cpu", bc, bg, gc, gg, Xn,
                             dict(group_data_pred=gn))
    print(f"[grouped card-vs-cpu] n={N_GROUPED_CPU} q={Q_GROUPED_CPU} "
          f"float64 {ROUNDS} rounds: {txt}; rounds card {sum(sg):.3f} s, "
          f"cpu {sum(sc):.3f} s", flush=True)


def phase_gaussian_fits(torch, gpt):
    """Gaussian mixed-model and exact-GP fits on the card: the LMM of
    examples/01_grouped_random_effects.py:14-24 at n = 100,000, q = 1,000
    with X and std_dev=True; exact GPs (BASELINE config 1) at n = 500,
    against the CPU, and at n = 5,000."""
    n, m = N_GROUPED, Q_GROUPED
    rng = np.random.RandomState(42)
    group = rng.randint(0, m, n)
    b = 0.8 * rng.randn(m)
    X = np.column_stack([np.ones(n), rng.rand(n)])
    y = X @ np.array([1.0, 2.0]) + b[group] + 0.5 * rng.randn(n)
    model = gpt.GPModel(group_data=group, device="cuda")
    t0 = time.perf_counter()
    _, syncs = _count_syncs(torch, lambda: model.fit(
        y=y, X=X, params={"std_dev": True}))
    secs = time.perf_counter() - t0
    cov = model.get_cov_pars(std_err=True)
    # as in the reference, the Woodbury engine reports no coefficient
    # standard errors (optimize.py:123-130 needs a dense Psi)
    coef = model.get_coef()
    if not (abs(cov[0, 0] / 0.25 - 1) < 0.05 and abs(cov[0, 1] / 0.64 - 1)
            < 0.3 and np.all(np.abs(coef - [1.0, 2.0]) < 0.2)
            and np.all(np.isfinite(cov)) and np.all(cov[1] > 0)):
        raise AssertionError(f"LMM: cov pars {cov}, coef {coef}")
    pred = model.predict(group_data_pred=[0, 1, 10 ** 6],
                         X_pred=[[1.0, 0.5]] * 3, predict_var=True)
    if not pred["var"][2] > pred["var"][0]:
        raise AssertionError("LMM: an unseen group's variance is not the "
                             "largest")
    print(f"[lmm] n={n} q={m} with X, std_dev: fit {secs:.3f} s, "
          f"{model.get_num_optim_iter()} iterations "
          f"({model._fit_result.optimizer}), host syncs {syncs}; cov pars "
          f"{cov[0].tolist()} (sd {cov[1].tolist()}), coef "
          f"{coef.tolist()}", flush=True)
    for ng in (500, 5_000):
        coords, yg = sim_vecchia(ng, seed=SEED)
        fits = {}
        for dev in ("cuda", "cpu") if ng == 500 else ("cuda",):
            gm = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                             device=dev)
            t0 = time.perf_counter()
            gm.fit(y=yg)
            if dev == "cuda":
                torch.cuda.synchronize()
            fits[dev] = (gm, time.perf_counter() - t0)
        gm, secs = fits["cuda"]
        cov = gm.get_cov_pars()
        if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
            raise AssertionError(f"exact GP n={ng}: cov pars {cov}")
        txt = ""
        if "cpu" in fits:
            rel = float(np.max(np.abs(cov / fits["cpu"][0].get_cov_pars()
                                      - 1.0)))
            if not rel < 1e-4:
                raise AssertionError(f"exact GP n={ng}: card {cov} cpu "
                                     f"{fits['cpu'][0].get_cov_pars()}")
            txt = f"; against the CPU max rel diff {rel:.3g}"
        pred = gm.predict(gp_coords_pred=coords[:50] + 0.005,
                          predict_var=True)
        if not (np.all(np.isfinite(pred["mu"]))
                and np.all(pred["var"] > 0)):
            raise AssertionError(f"exact GP n={ng}: predictions")
        print(f"[exact-gp] n={ng} exponential float64: fit {secs:.3f} s, "
              f"{gm.get_num_optim_iter()} iterations "
              f"({gm._fit_result.optimizer}); cov pars {cov.tolist()}{txt}",
              flush=True)


def phase_vecchia_headline(torch, gpt):
    """The headline fit (bench.py:231-245): sim_vecchia n = 100,000, 20
    neighbours, random ordering, float32, lbfgs with maxit 30 and
    init_cov_pars [0.5, 1.0, 0.1]. By default (n >= 20,000) it must take
    the device L-BFGS; the scipy path's iteration count is printed
    beside it."""
    coords, y = sim_vecchia(N_VECCHIA)
    t0 = time.perf_counter()
    model = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=20,
                        vecchia_ordering="random", dtype="float32",
                        device="cuda")
    setup_s = time.perf_counter() - t0
    params = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.5, 1.0, 0.1]}
    model.fit(y=y, params={**params, "maxit": 1})          # first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(torch, lambda: model.fit(
        y=y, params={**params, "maxit": MAXIT_VECCHIA}))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = model._fit_result
    if r.optimizer != "device_lbfgs":
        raise AssertionError(f"headline fit took the {r.optimizer} path")
    cov = model.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"headline fit: cov pars {cov}")
    t0 = time.perf_counter()
    model.fit(y=y, params={**params, "maxit": MAXIT_VECCHIA,
                           "use_device_optimizer": False})
    torch.cuda.synchronize()
    scipy_s = time.perf_counter() - t0
    rs = model._fit_result
    print(f"[vecchia-headline] n={N_VECCHIA} m=20 float32 lbfgs maxit "
          f"{MAXIT_VECCHIA}: engine setup {setup_s:.3f} s; device L-BFGS "
          f"{r.num_it} iterations in {secs:.3f} s, {syncs} host syncs, nll "
          f"{r.neg_log_likelihood:.4f}, cov pars {cov.tolist()}; scipy "
          f"L-BFGS-B (forced) {rs.num_it} iterations in {scipy_s:.3f} s, "
          f"nll {rs.neg_log_likelihood:.4f}, cov pars "
          f"{rs.cov_pars.tolist()}", flush=True)


def sim_glmm(n, q, seed=SEED_GLMM):
    """bench.py sim_glmm: a binary response with a random intercept."""
    rng = np.random.RandomState(seed)
    g = rng.randint(0, q, n)
    b = 0.8 * rng.normal(size=q)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-b[g]))).astype(float)
    return g, y


def sim_crossed_poisson(n, q1, q2, seed=SEED_GLMM):
    """Counts with two crossed random intercepts."""
    rng = np.random.RandomState(seed)
    g = np.column_stack([rng.randint(0, q1, n), rng.randint(0, q2, n)])
    b1, b2 = 0.6 * rng.normal(size=q1), 0.4 * rng.normal(size=q2)
    y = rng.poisson(np.exp(0.3 + b1[g[:, 0]] + b2[g[:, 1]])).astype(float)
    return g, y


def sim_lagaboost(n, q, seed=SEED_LAGA):
    """examples/04_non_gaussian.py:13-16, 40-43 at n rows and q groups."""
    rng = np.random.RandomState(seed)
    group = rng.randint(0, q, n)
    b = rng.randn(q)
    X = rng.rand(n, P_LAGA)
    F_true = 2.0 * np.sin(7 * X[:, 0]) + X[:, 1]
    y = (rng.rand(n) < 1 / (1 + np.exp(-(F_true - 1 + b[group])))).astype(
        float)
    return X, group, y


def _reference_time(key):
    """(seconds, iterations, threads) of the reference C++ library from
    BASELINE_MEASURED.json (bench_reference.py), or None."""
    try:
        with open("BASELINE_MEASURED.json") as f:
            d = json.load(f)
        w = d["workloads"][key]
        return w["seconds"], w.get("num_it"), d.get("threads")
    except (OSError, KeyError, ValueError):
        return None


def _glmm_fits(torch, gpt, what, group, y, likelihood, cpu_check):
    """A Laplace GLMM on the card: a first fit, a timed second fit after
    reset_fit with its host syncs, a third under the profiler; optionally
    the same fit on the CPU. Returns the card's model."""
    model = gpt.GPModel(group_data=group, likelihood=likelihood,
                        device="cuda")
    params = {"maxit": MAXIT_GLMM}
    t0 = time.perf_counter()
    model.fit(y=y, params=params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    model.reset_fit()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(torch, lambda: model.fit(y=y, params=params))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = model._fit_result
    if r.optimizer != "device_lbfgs":
        raise AssertionError(f"{what}: the fit took the {r.optimizer} path")
    cov = model.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"{what}: cov pars {cov}")
    model.reset_fit()
    busy, wall, _ = _device_busy_s(torch, lambda: model.fit(y=y,
                                                            params=params))
    steps = model._engine.total_num_mode_it
    txt = ""
    if cpu_check:
        mc = gpt.GPModel(group_data=group, likelihood=likelihood,
                         device="cpu")
        t0 = time.perf_counter()
        mc.fit(y=y, params=params)
        cpu_s = time.perf_counter() - t0
        rel = float(np.max(np.abs(cov / mc.get_cov_pars() - 1.0)))
        if not (rel < 1e-4
                and mc.get_num_optim_iter() == model.get_num_optim_iter()):
            raise AssertionError(
                f"{what}: card {cov} ({model.get_num_optim_iter()} its), "
                f"cpu {mc.get_cov_pars()} ({mc.get_num_optim_iter()} its)")
        txt = (f"; CPU fit of the port {cpu_s:.3f} s, "
               f"{mc.get_num_optim_iter()} iterations, variance max rel "
               f"diff {rel:.3g}")
    print(f"[{what}] {likelihood}, first fit {first_s:.3f} s; after "
          f"reset_fit {secs:.4f} s, {r.num_it} device L-BFGS iterations, "
          f"{syncs} host syncs; device busy over a third fit: "
          f"{_busy_txt(busy, wall)} ({steps} Newton steps over the "
          f"engine's fits); nll {r.neg_log_likelihood:.4f}, cov pars "
          f"{cov.tolist()}{txt}", flush=True)
    return model


def phase_glmm(torch, gpt):
    """bench.py's grouped_glmm on the card (the padded mode finder), then
    a crossed Poisson GLMM (the rows mode finder)."""
    g, y = sim_glmm(N_GLMM, Q_GLMM)
    model = _glmm_fits(torch, gpt, f"glmm n={N_GLMM} q={Q_GLMM}", g, y,
                       "bernoulli_logit", cpu_check=True)
    if model._engine._padded is None:
        raise AssertionError("glmm: the padded mode finder did not run")
    ref = _reference_time("grouped_glmm_bernoulli_n100k_q1k_fit")
    if ref is not None:
        print(f"[glmm] the reference C++ library (BASELINE_MEASURED.json, "
              f"bench_reference.py, {ref[2]} CPU thread(s)): {ref[0]} s, "
              f"{ref[1]} iterations", flush=True)
    g2, y2 = sim_crossed_poisson(N_GLMM, Q_GLMM, Q_GLMM2)
    model = _glmm_fits(torch, gpt, f"glmm crossed n={N_GLMM} "
                       f"q={Q_GLMM}+{Q_GLMM2}", g2, y2, "poisson",
                       cpu_check=False)
    if model._engine._padded is not None \
            or model._engine.q != Q_GLMM + Q_GLMM2:
        raise AssertionError("crossed glmm: not the rows mode finder")


def _train_lagaboost(torch, gpt, n, q, device, rounds=ROUNDS,
                     dtype="float64"):
    """(booster, gp, construction s incl. the init score, first-fit s,
    per-round s)."""
    X, group, y = sim_lagaboost(n, q)
    gp = gpt.GPModel(group_data=group, likelihood="bernoulli_logit",
                     device=device, dtype=dtype)
    fit_secs = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        fit_secs.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    t0 = time.perf_counter()
    bst = gpt.Booster(LAGA, gpt.Dataset(X, label=y), gp_model=gp,
                      device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        bst.update()
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs[0] -= fit_secs[0]
    return bst, gp, init_s, fit_secs[0], secs


def phase_lagaboost(torch, gpt, histogram):
    """LaGaBoost at full width (n = 100,000, q = 1,000, p = 5) for 10
    rounds, then the response for 1,000 new rows, half in unseen groups.
    Returns hist_segment's launches over the 10 rounds."""
    _reset_launches(histogram)
    bst, gp, init_s, fit_s, secs = _train_lagaboost(torch, gpt, N_LAGA,
                                                    Q_LAGA, "cuda")
    launches = histogram.hist_segment.launches
    from collections import Counter
    tree_syncs, sites = [], Counter()
    train = bst.learner.train

    def counted_train(*args, **kwargs):
        out, s = _count_syncs(torch, lambda: train(*args, **kwargs), sites)
        tree_syncs.append(s)
        return out

    bst.learner.train = counted_train
    _, syncs = _count_syncs(torch, bst.update, sites)
    bst.learner.train = train
    print("[lagaboost] host syncs of round 11 by Python line: " + ", ".join(
        f"{k} x{v}" for k, v in sites.most_common(12)), flush=True)
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)])
    Xn, gn = _grouped_new_rows(Q_LAGA, N_PRED)
    Xn = Xn[:, :P_LAGA]
    t0 = time.perf_counter()
    pred = bst.predict(Xn, group_data_pred=gn, predict_var=True)
    latent = bst.predict(Xn, group_data_pred=gn, predict_var=True,
                         pred_latent=True)
    pred_s = time.perf_counter() - t0
    half = N_PRED // 2
    if not np.array_equal(latent["random_effect_mean"][half:],
                          np.zeros(N_PRED - half)):
        raise AssertionError("lagaboost: unseen groups' latent means are "
                             "not exactly 0")
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"lagaboost: prediction {k}")
    if not (np.all(pred["response_mean"] > 0)
            and np.all(pred["response_mean"] < 1)):
        raise AssertionError("lagaboost: probabilities outside (0, 1)")
    cov = gp.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"lagaboost: covariance parameters {cov}")
    if launches <= 0:
        raise AssertionError(f"lagaboost: {launches} hist_segment launches")
    print(f"[lagaboost] n={N_LAGA} q={Q_LAGA} p={P_LAGA} bernoulli_logit "
          f"float64, {ROUNDS} rounds: booster with init score "
          f"{init_s:.3f} s (init score {bst.init_score:.5f}); first GP fit "
          f"{fit_s:.3f} s ({gp._fit_result.optimizer}); mean per round "
          f"{np.mean(secs):.4f} s (min {np.min(secs):.4f}, max "
          f"{np.max(secs):.4f}); host syncs in round {ROUNDS + 1}: "
          f"{syncs + tree_syncs[0]} ({tree_syncs[0]} in the tree, {syncs} "
          f"in the rest); device busy over rounds {ROUNDS + 2}-"
          f"{ROUNDS + 3}: {_busy_txt(busy, wall, hist_s)}; predict "
          f"{N_PRED} rows twice {pred_s:.3f} s; cov pars {cov.tolist()}; "
          f"hist_segment launches over the {ROUNDS} rounds {launches}",
          flush=True)
    return launches


def phase_lagaboost_goldens(torch, gpt):
    """tests/test_lagaboost_golden.py TestBinaryGrouped on the card, at
    that file's tolerances."""
    from scipy.stats import norm
    ntrain, n_new, m = 1000, 3, 40
    n = 2 * ntrain
    X = np.reshape(lcg_unif(4 * n, 0.2644234), (4, n)).T.copy()
    X[:, 0] *= 100
    X[:, 1] = X[:, 1] * np.pi * (560 - 40) + 40 * np.pi
    X[:, 3] = X[:, 3] * 10 + 1
    f = np.sqrt(10) * np.arctan(
        (X[:, 1] * X[:, 2] - 1 / (X[:, 1] * X[:, 3])) / X[:, 0])
    X = np.column_stack([np.ones(n), X,
                         np.reshape(lcg_unif(5 * n, 0.6543), (5, n)).T])
    f = f - f.mean()
    g1 = np.repeat(np.arange(1, m + 1), ntrain // m).astype(float)
    g1 = np.concatenate([g1, g1])
    g1[-n_new:] = 99999
    g2 = np.tile(np.arange(1, ntrain // m + 1), m).astype(float)
    g2 = np.concatenate([g2, g2])
    g2[-n_new:] = 99999
    _, i1 = np.unique(g1, return_inverse=True)
    _, i2 = np.unique(g2, return_inverse=True)
    b1 = np.sqrt(0.6) * norm.ppf(lcg_unif(len(np.unique(g1)), 0.5542))
    b2 = np.sqrt(0.4) * norm.ppf(lcg_unif(len(np.unique(g2)), 0.82354))
    eps = b1[i1] + b2[i2]
    eps = eps - eps.mean()
    gd = np.column_stack([g1, g2])
    y = (lcg_unif(n, 0.574) < norm.cdf(f + eps)).astype(float)
    boost = {"learning_rate": 0.1, "max_depth": 6, "min_data_in_leaf": 5,
             "verbose": 0}
    opt = {"optimizer_cov": "gradient_descent", "use_nesterov_acc": False,
           "delta_rel_conv": 1e-6, "lr_cov": 0.01, "lr_coef": 0.1,
           "init_cov_pars": [1.0, 1.0],
           "init_coef_aux_pars_from_iid_model": False}

    def run(params):
        gp = gpt.GPModel(group_data=gd[:ntrain],
                         likelihood="bernoulli_probit", device="cuda")
        gp.set_optim_params(params=opt)
        bst = gpt.train(params, gpt.Dataset(X[:ntrain], label=y[:ntrain]),
                        num_boost_round=30, gp_model=gp, device="cuda")
        return gp, bst

    t0 = time.perf_counter()
    gp, bst = run({**boost, "objective": "binary"})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cp = np.asarray(gp.get_cov_pars()).ravel()
    nll = gp.get_current_neg_log_likelihood()
    errs = []
    if not np.sum(np.abs(cp - [0.4578282, 0.3456973])) < 0.05:
        errs.append(f"cov pars {cp}")
    if not abs(nll - 372.1352713) < 10:
        errs.append(f"nll {nll}")
    pred = bst.predict(X[ntrain:], group_data_pred=gd[ntrain:],
                       predict_var=True, pred_latent=True)
    d_fe = np.sum(np.abs(pred["fixed_effect"][:4] - [
        0.51189335, -0.05534681, 1.01832308, 0.82839003]))
    d_re = np.sum(np.abs(pred["random_effect_mean"][-6:] - [
        -1.122524, -1.070761, -1.239508, 0, 0, 0]))
    d_rv = np.sum(np.abs(pred["random_effect_cov"][-6:] - [
        0.1291345, 0.1285406, 0.1291397, 0.8035255, 0.8035255, 0.8035255]))
    if not (d_fe < 0.5 and d_re < 0.12 and d_rv < 0.05):
        errs.append(f"latent prediction {d_fe}, {d_re}, {d_rv}")
    if not np.array_equal(pred["random_effect_mean"][-3:], np.zeros(3)):
        errs.append("new groups' latent means not exactly 0")
    pred = bst.predict(X[ntrain:], group_data_pred=gd[ntrain:],
                       predict_var=True, pred_latent=False)
    d_m = np.sum(np.abs(pred["response_mean"][-4:] - [
        0.01602001, 0.63412570, 0.20171037, 0.62036433]))
    d_v = np.sum(np.abs(pred["response_var"][-4:] - [
        0.01576337, 0.23201030, 0.16102330, 0.23551243]))
    if not (d_m < 0.12 and d_v < 0.06):
        errs.append(f"response prediction {d_m}, {d_v}")
    gp2, bst2 = run(dict(boost))         # the objective from the GP model
    cp2 = np.asarray(gp2.get_cov_pars()).ravel()
    if not (np.sum(np.abs(cp2 - [0.4578282, 0.3456973])) < 0.05
            and bst2.objective_name == "bernoulli_probit"):
        errs.append(f"inferred objective: {bst2.objective_name}, {cp2}")
    gp3 = gpt.GPModel(group_data=gd[:ntrain], likelihood="bernoulli_probit",
                      device="cuda")
    gp3.set_optim_params(params={"maxit": 2,
                                 "optimizer_cov": "fisher_scoring"})
    try:
        gpt.train({**boost, "objective": "binary"},
                  gpt.Dataset(X[:ntrain], label=y[:ntrain]),
                  num_boost_round=1, gp_model=gp3, device="cuda")
        errs.append("fisher_scoring was not rejected")
    except ValueError:
        pass
    if errs:
        raise AssertionError("lagaboost goldens: " + "; ".join(errs))
    print(f"[lagaboost-goldens] ntrain={ntrain}, 30 rounds in {secs:.2f} s: "
          f"cov pars {cp.tolist()} (golden [0.4578282, 0.3456973]), nll "
          f"{nll:.4f} (golden 372.1352713); latent |diff| sums fe {d_fe:.3g}"
          f", re {d_re:.3g}, var {d_rv:.3g}; response {d_m:.3g}, {d_v:.3g}; "
          "objective inferred, fisher_scoring rejected", flush=True)


def phase_laplace_card_vs_cpu(torch, gpt):
    """LaGaBoost at n = 2,000, q = 50 in float64, card against CPU; the
    dense Laplace engine on a bernoulli_probit exponential GP at n = 500
    (card against CPU) and n = 5,000."""
    runs = {dev: _train_lagaboost(torch, gpt, N_LAGA_CPU, Q_LAGA_CPU, dev)
            for dev in ("cuda", "cpu")}
    (bg, gg, _, _, sg), (bc, gc, _, _, sc) = runs["cuda"], runs["cpu"]
    res = _compare_models("lagaboost card-vs-cpu", bc, bg)
    cg, cc = gg.get_cov_pars(), gc.get_cov_pars()
    cov_rel = float(np.max(np.abs(cg / cc - 1.0)))
    if not cov_rel < 1e-4:
        raise AssertionError(f"lagaboost cov pars card {cg} cpu {cc}")
    k = next((t for t, (a, b) in enumerate(zip(bc.trees, bg.trees))
              if [r[:3] for r in _split_records(a)]
              != [r[:3] for r in _split_records(b)]), len(bc.trees))
    Xn, gn = _grouped_new_rows(Q_LAGA_CPU, 200)
    Xn = Xn[:, :P_LAGA]
    # a near tie moves the fixed effect of new rows from that tree on, so
    # the response is compared only when every split agrees
    checks = [(True, ("random_effect_mean", "random_effect_var"))]
    if k == len(bc.trees):
        checks.append((False, ("response_mean", "response_var")))
    errs = {}
    for latent, keys in checks:
        pg = bg.predict(Xn, group_data_pred=gn, predict_var=True,
                        pred_latent=latent)
        pc = bc.predict(Xn, group_data_pred=gn, predict_var=True,
                        pred_latent=latent)
        for key in keys:
            errs[key] = float(np.max(np.abs(pg[key] - pc[key])))
    errs["training score"] = float((bg.F.cpu() - bc.F).abs().max())
    if not max(errs.values()) < 1e-4:
        raise AssertionError(f"lagaboost card vs CPU: max |diff| {errs}")
    print(f"[lagaboost card-vs-cpu] n={N_LAGA_CPU} q={Q_LAGA_CPU} float64 "
          f"{ROUNDS} rounds: trees {res}; cov pars max rel diff "
          f"{cov_rel:.3g}; max |diff| "
          + ", ".join(f"{key} {v:.3g}" for key, v in errs.items())
          + f"; rounds card {sum(sg):.3f} s, cpu {sum(sc):.3f} s",
          flush=True)
    from scipy.stats import norm
    for ng in (500, 5_000):
        coords, f = sim_vecchia(ng, seed=SEED)
        rng = np.random.RandomState(SEED)
        y = (rng.rand(ng) < norm.cdf(f)).astype(float)
        fits = {}
        for dev in ("cuda", "cpu") if ng == 500 else ("cuda",):
            gm = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                             likelihood="bernoulli_probit", device=dev)
            t0 = time.perf_counter()
            gm.fit(y=y)
            if dev == "cuda":
                torch.cuda.synchronize()
            fits[dev] = (gm, time.perf_counter() - t0)
        gm, secs = fits["cuda"]
        cov = gm.get_cov_pars()
        if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
            raise AssertionError(f"dense Laplace n={ng}: cov pars {cov}")
        txt = ""
        if "cpu" in fits:
            gc_ = fits["cpu"][0]
            rel = float(np.max(np.abs(cov / gc_.get_cov_pars() - 1.0)))
            if not rel < 1e-4:
                raise AssertionError(f"dense Laplace n={ng}: card {cov} "
                                     f"cpu {gc_.get_cov_pars()}")
            txt = (f"; against the CPU max rel diff {rel:.3g} "
                   f"({gc_.get_num_optim_iter()} iterations there)")
        pred = gm.predict(gp_coords_pred=coords[:50] + 0.005,
                          predict_var=True)
        if not (np.all(pred["mu"] > 0) and np.all(pred["mu"] < 1)):
            raise AssertionError(f"dense Laplace n={ng}: predictions")
        print(f"[dense-laplace] n={ng} bernoulli_probit exponential float64:"
              f" fit {secs:.3f} s, {gm.get_num_optim_iter()} iterations "
              f"({gm._fit_result.optimizer}), "
              f"{gm._engine.total_num_mode_it} Newton steps; cov "
              f"pars {cov.tolist()}{txt}", flush=True)


def sim_vl(n, seed=SEED_VL):
    """bench.py sim_vl: a binary response with a spatial probit field."""
    from scipy.stats import norm
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    f = np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    y = (rng.rand(n) < norm.cdf(f)).astype(float)
    return coords, y


def sim_lagab(n, p=P_VLB, seed=SEED_VLB):
    """bench.py sim_lagab: trees' signal plus a spatial field, probit."""
    from scipy.stats import norm
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, p)
    lat = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 1.0
           + 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1]))
    y = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return coords, X, y


def _vl_fit(torch, gpt, coords, y, dtype, device="cuda"):
    """(model, seconds) of one Vecchia-Laplace fit with VL_FIT."""
    model = gpt.GPModel(gp_coords=coords, dtype=dtype, device=device,
                        **VL_MODEL)
    t0 = time.perf_counter()
    model.fit(y=y, params=VL_FIT)
    if device == "cuda":
        torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_vecchia_laplace(torch, gpt):
    """bench.py's vecchia_laplace_n20k at full width: sim_vl n = 20,000,
    seed 3, bernoulli_probit, exponential, 20 neighbours, the dense
    precision path (cholesky), float32, maxit 20, init_cov_pars
    [1.0, 0.1]. One fit (seconds, iterations, Newton steps, host syncs,
    peak device memory); then one float64 fit, whose covariance parameters
    phase 24 holds the iterative fit to (returned). The profiled third fit
    of earlier runs was cut for phases 23-26, the second after reset_fit
    for phases 27-29."""
    coords, y = sim_vl(N_VL)
    torch.cuda.reset_peak_memory_stats()
    model = gpt.GPModel(gp_coords=coords, dtype="float32", device="cuda",
                        **VL_MODEL)
    eng = model._engine
    t0 = time.perf_counter()
    _, syncs = _count_syncs(torch, lambda: model.fit(y=y, params=VL_FIT))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = eng.total_num_mode_it
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = model._fit_result
    cov = model.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)
            and 0 < r.num_it <= MAXIT_VL):
        raise AssertionError(f"vecchia-laplace: cov pars {cov}, "
                             f"{r.num_it} iterations")
    print(f"[vecchia-laplace] n={N_VL} m={M_VL} bernoulli_probit cholesky "
          f"float32: fit {secs:.3f} s, {r.num_it} iterations "
          f"({r.optimizer}), {steps} "
          f"Newton steps, {syncs} host syncs; peak device memory "
          f"{peak:.2f} GiB; nll "
          f"{r.neg_log_likelihood:.4f}, cov pars {cov.tolist()}", flush=True)
    ref = _reference_time("vecchia_laplace_fit_n20k_binary")
    if ref is not None:
        print(f"[vecchia-laplace] the reference C++ library "
              f"(BASELINE_MEASURED.json, bench_reference.py, {ref[2]} CPU "
              f"thread(s)): {ref[0]} s, {ref[1]} iterations", flush=True)
    del model, eng
    torch.cuda.empty_cache()
    m64, secs64 = _vl_fit(torch, gpt, coords, y, "float64")
    cov64 = m64.get_cov_pars()
    if not (np.all(np.isfinite(cov64)) and np.all(cov64 > 0)
            and 0 < m64.get_num_optim_iter() <= MAXIT_VL):
        raise AssertionError(f"vecchia-laplace float64: cov pars {cov64}")
    print(f"[vecchia-laplace] float64 on the card: {secs64:.3f} s, "
          f"{m64.get_num_optim_iter()} iterations, "
          f"{m64._engine.total_num_mode_it} Newton steps, nll "
          f"{m64._fit_result.neg_log_likelihood:.4f}, cov pars "
          f"{cov64.tolist()} (float32: {cov.tolist()}, max rel diff "
          f"{float(np.max(np.abs(cov / cov64 - 1.0))):.3g})", flush=True)
    return cov64


def phase_segment_vl(torch, gpt, histogram, kernel_row, n_rows=N_VL):
    """hist_segment at Vecchia LaGaBoost's shapes: sim_lagab's n_rows
    (20,000 in phase 21, 50,000 in phase 25) rows, p = 5 (`_segment_at`)."""
    _, X, y = sim_lagab(n_rows)
    ds = gpt.Dataset(X, label=y)
    ds.construct()
    _segment_at(torch, histogram, ds, kernel_row, SEED_VLB)


def _segment_at(torch, histogram, ds, kernel_row, seed):
    """hist_segment at a Dataset's shapes (uint8, the real bin count):
    whole and part segments and a one-bin feature with the checks of phase
    3, and the whole segment's times (the kernel's, the plain version's,
    index_add_'s), added to kernel_row under "at_n<n/1000>k_p<p>"."""
    dev = torch.device("cuda")
    num_bins = int(ds.num_bins)
    n, p = ds.bins.shape
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    stats = np.ones((n, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(n)
    stats[:, 1] = rng.rand(n) + 0.5
    stats_d = torch.as_tensor(stats, device=dev)
    bins = torch.as_tensor(np.ascontiguousarray(ds.bins, dtype=np.uint8),
                           device=dev)
    for name, b, s0, cnt in (("whole", bins, 0, n),
                             ("part", bins, 1234, min(7_777, n - 1234)),
                             ("one-bin feature", _one_bin(bins, 1), 0, n)):
        tol = 1e-5 * float(histogram.hist_segment_plain(
            b, stats_d, s0, cnt, num_bins)[:, :2].abs().max())
        _segment_case(torch, histogram, f"hist_segment n={n} p={p} {name}",
                      b, stats_d, s0, cnt, num_bins, max(tol, 1e-5), gen)
    amax = histogram.stat_amax(stats_d, 0)

    def kernel():
        return histogram.hist_segment(bins, stats_d, 0, n, num_bins,
                                      amax=amax)
    bound_ms, bound_by = bound(n * p + 12 * n + 12 * p * num_bins, 3 * n * p)
    row = {"ms": _time_ms(torch, kernel),
           "device_ms": _device_ms(torch, kernel),
           "plain_ms": _time_ms(torch, lambda: histogram.hist_segment_plain(
               bins, stats_d, 0, n, num_bins)),
           "library_ms": _segment_library_ms(torch, bins, stats_d, 0, n,
                                             num_bins, kernel()),
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[kernel] hist_segment n={n} p={p} B={num_bins} uint8, whole "
          f"segment: {row['ms']:.4f} ms by events, "
          f"{_fmt_ms(row['device_ms'])} device, plain {row['plain_ms']:.4f} "
          f"ms, index_add_ {row['library_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    kernel_row[f"at_n{n // 1000}k_p{p}"] = row


def _train_vl_lagaboost(torch, gpt, n, device, dtype, rounds,
                        model=VL_MODEL, gp_params=None, params=VLB):
    """(booster, gp, construction s incl. the init score, first-fit s,
    per-round s) of binary Vecchia LaGaBoost on sim_lagab."""
    coords, X, y = sim_lagab(n)
    gp = gpt.GPModel(gp_coords=coords, dtype=dtype, device=device,
                     **model)
    if gp_params:
        gp.set_optim_params(params=gp_params)
    fit_secs = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        fit_secs.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    t0 = time.perf_counter()
    bst = gpt.Booster(params, gpt.Dataset(X, label=y), gp_model=gp,
                      device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        bst.update()
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs[0] -= fit_secs[0]
    gp.fit = fit
    return bst, gp, init_s, fit_secs[0], secs


def phase_vecchia_lagaboost(torch, gpt, histogram):
    """Binary Vecchia LaGaBoost at n = 20,000, p = 5 (sim_lagab, seed 4;
    the GP model of phase 20 in float32; 31 leaves, learning rate 0.1) for
    ROUNDS_VL_DENSE (1) rounds (10, then 3, in earlier runs; cut to make
    room for phases 23-26 and 39-41), then the response on 1,000 new
    points. Returns hist_segment's launches over those rounds."""
    _reset_launches(histogram)
    bst, gp, init_s, fit_s, secs = _train_vl_lagaboost(
        torch, gpt, N_VL, "cuda", "float32", ROUNDS_VL_DENSE)
    launches = histogram.hist_segment.launches
    from collections import Counter
    sites, kernels, counted = Counter(), {}, {}
    # one more round, profiled, whose host syncs are counted too (a round
    # each before the script's time limit forced the cut, and two profiled
    # before phases 27-29)
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: counted.update(
            syncs=_count_syncs(torch, bst.update, sites)[1]),
        by_name=kernels)
    syncs = counted["syncs"]
    print(f"[vecchia-lagaboost] host syncs of round {ROUNDS_VL_DENSE + 1} by "
          "Python line: "
          + ", ".join(f"{k} x{v}" for k, v in sites.most_common(8)),
          flush=True)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"[vecchia-lagaboost] device time of round {ROUNDS_VL_DENSE + 1} "
          "by kernel: "
          + "; ".join(f"{k[:70]} {v:.3f} s" for k, v in top), flush=True)
    rng = np.random.RandomState(SEED_VLB + 1)
    Xn, cn = rng.rand(N_PRED, P_VLB), rng.rand(N_PRED, 2)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pred_s = time.perf_counter() - t0
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"vecchia lagaboost: prediction {k}")
    if not (np.all(pred["response_mean"] > 0)
            and np.all(pred["response_mean"] < 1)):
        raise AssertionError("vecchia lagaboost: probabilities outside "
                             "(0, 1)")
    cov = gp.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"vecchia lagaboost: cov pars {cov}")
    if launches <= 0:
        raise AssertionError(f"vecchia lagaboost: {launches} hist_segment "
                             "launches")
    print(f"[vecchia-lagaboost] n={N_VL} p={P_VLB} m={M_VL} bernoulli_probit "
          f"float32, {ROUNDS_VL_DENSE} rounds: booster with init score "
          f"{init_s:.3f} s "
          f"(init score {bst.init_score:.5f}); first GP fit {fit_s:.3f} s "
          f"({gp._fit_result.optimizer}, {gp._fit_result.num_it} "
          f"iterations); mean per round {np.mean(secs):.4f} s (min "
          f"{np.min(secs):.4f}, max {np.max(secs):.4f}); host syncs in round "
          f"{ROUNDS_VL_DENSE + 1}: {syncs}; device busy over that round: "
          f"{_busy_txt(busy, wall, hist_s)}; predict "
          f"{N_PRED} points {pred_s:.3f} s; cov pars {cov.tolist()}; "
          f"hist_segment launches over the {ROUNDS_VL_DENSE} rounds "
          f"{launches}",
          flush=True)
    return launches


def _vl_golden_data():
    """tests/test_vecchia_laplace_golden.py vl_data (n = 100)."""
    from scipy import stats
    from gpboost_tpu_torch.utils.datasim import qnorm, sim_rand_unif
    n, d = 100, 2
    coords = sim_rand_unif(n * d, init_c=0.1).reshape(d, n).T
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    L = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    probs = stats.norm.cdf(L @ qnorm(sim_rand_unif(n, init_c=0.8)))
    y = (sim_rand_unif(n, init_c=0.19341) < probs).astype(float)
    X = np.column_stack([np.ones(n), np.sin(
        (np.arange(1, n + 1) - n / 2) ** 2 * 2 * np.pi / n)])
    return coords, D, y, X


def phase_vecchia_laplace_card_vs_cpu(torch, gpt):
    """Card against CPU at n = N_VL_CPU (1,000; 2,000 before the script's
    time limit forced the cut; float64, 20 neighbours, random ordering):
    the engine's NLL and gradients in u and F (rtol 1e-8) and Newton
    steps, a fit (rtol 1e-4, equal iterations) and 1 round of LaGaBoost
    (3 before phases 39-41; phase 5's near-tie rule, predictions to
    1e-4); then the R
    goldens of tests/test_vecchia_laplace_golden.py on the card."""
    coords, y = sim_vl(N_VL_CPU)
    F = 0.3 * np.sin(np.arange(N_VL_CPU))
    u = np.log([0.9, 1.0 / 0.1])
    ev = {}
    for dev in ("cuda", "cpu"):
        eng = gpt.GPModel(gp_coords=coords, dtype="float64", device=dev,
                          **VL_MODEL)._engine
        nll, gu, gF, _ = eng.laplace_vag_F(u, y, F, eng.zero_mode())
        ev[dev] = (nll, gu, gF, eng.last_num_mode_it)
    (ng, gug, gFg, sg), (nc, guc, gFc, sc) = ev["cuda"], ev["cpu"]
    errs = {"nll": abs(ng / nc - 1.0),
            "g_u": float(np.max(np.abs(gug / guc - 1.0))),
            "g_F": float(np.max(np.abs(gFg - gFc)) / np.max(np.abs(gFc)))}
    if not (max(errs.values()) < 1e-8 and sg == sc):
        raise AssertionError(f"vecchia-laplace engine card vs CPU: {errs}, "
                             f"Newton steps {sg} vs {sc}")
    fits = {dev: _vl_fit(torch, gpt, coords, y, "float64", dev)
            for dev in ("cuda", "cpu")}
    cg, cc = fits["cuda"][0].get_cov_pars(), fits["cpu"][0].get_cov_pars()
    ig, ic = (fits[d][0].get_num_optim_iter() for d in ("cuda", "cpu"))
    fit_rel = float(np.max(np.abs(cg / cc - 1.0)))
    if not (fit_rel < 1e-4 and ig == ic):
        raise AssertionError(f"vecchia-laplace fit card {cg} ({ig} its) "
                             f"cpu {cc} ({ic} its)")
    runs = {dev: _train_vl_lagaboost(torch, gpt, N_VL_CPU, dev, "float64", 1)
            for dev in ("cuda", "cpu")}
    (bg, _, _, _, _), (bc, _, _, _, _) = runs["cuda"], runs["cpu"]
    res = _compare_models("vecchia-lagaboost card-vs-cpu", bc, bg)
    rng = np.random.RandomState(SEED_VLB + 2)
    Xn, cn = rng.rand(200, P_VLB), rng.rand(200, 2)
    perr = {}
    for latent in (True, False):
        keys = ("random_effect_mean", "random_effect_var") if latent \
            else ("response_mean", "response_var")
        if not latent and res == "near tie":
            continue
        pg = bg.predict(Xn, gp_coords_pred=cn, predict_var=True,
                        pred_latent=latent)
        pc = bc.predict(Xn, gp_coords_pred=cn, predict_var=True,
                        pred_latent=latent)
        for k in keys:
            perr[k] = float(np.max(np.abs(pg[k] - pc[k])))
    perr["training score"] = float((bg.F.cpu() - bc.F).abs().max())
    if not max(perr.values()) < 1e-4:
        raise AssertionError(f"vecchia lagaboost card vs CPU: {perr}")
    print(f"[vecchia-laplace card-vs-cpu] n={N_VL_CPU} m={M_VL} float64: "
          "engine max rel diff " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in errs.items())
          + f", Newton steps {sg} both; fit cov pars max rel diff "
          f"{fit_rel:.3g}, {ig} iterations both (card "
          f"{fits['cuda'][1]:.3f} s, cpu {fits['cpu'][1]:.3f} s); "
          f"LaGaBoost 1 round: trees {res}; max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in perr.items()), flush=True)
    # the R goldens (n = 100, m = 99, ordering none) on the card
    coords, D, yg, X = _vl_golden_data()
    kw = {**VL_MODEL, "num_neighbors": 99, "vecchia_ordering": "none"}
    gm = gpt.GPModel(gp_coords=coords, device="cuda", **kw)
    nll = gm.neg_log_likelihood(cov_pars=[1.0, 0.2], y=yg)
    iu = np.triu_indices(100, k=1)
    gm.fit(y=yg, X=X, params=dict(
        optimizer_cov="gradient_descent", optimizer_coef="gradient_descent",
        use_nesterov_acc=True, lr_cov=0.1, lr_coef=0.1, maxit=1000,
        acc_rate_cov=0.5, init_cov_pars=[1.0, np.mean(D[iu]) / 3]))
    d_cov = np.sum(np.abs(gm.get_cov_pars() - [0.92350821208,
                                               0.05944214192]))
    d_coef = np.sum(np.abs(gm.get_coef() - [0.3983333, -0.2653886]))
    coord_test = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
    X_test = np.column_stack([np.ones(3), [-0.5, 0.2, 1.0]])
    kwp = dict(y=yg, gp_coords_pred=coord_test, predict_var=True,
               cov_pars=[1.0, 0.2], X_pred=X_test)
    pl = gm.predict(predict_response=False, **kwp)
    pr = gm.predict(predict_response=True, **kwp)
    d_pred = [np.sum(np.abs(pl["mu"] - [0.3389905, 0.1512445, -0.1039307])),
              np.sum(np.abs(pl["var"] - [0.6193229, 0.6159349, 0.4291674])),
              np.sum(np.abs(pr["mu"] - [0.6050312, 0.5473537, 0.4653610])),
              np.sum(np.abs(pr["var"] - [0.2389684, 0.2477576, 0.2488001]))]
    if not (abs(nll - 67.18342059) < 1e-6 and d_cov < 1e-6
            and d_coef < 1e-6 and gm.get_num_optim_iter() == 17
            and max(d_pred) < 1e-3):
        raise AssertionError(
            f"vecchia-laplace goldens on the card: nll {nll}, cov "
            f"{d_cov}, coef {d_coef}, {gm.get_num_optim_iter()} its, "
            f"predictions {d_pred}")
    print(f"[vecchia-laplace goldens] on the card: nll {nll:.8f} (golden "
          f"67.18342059), GD fit with covariates {gm.get_num_optim_iter()} "
          f"iterations (golden 17), |diff| sums cov {d_cov:.3g}, coef "
          f"{d_coef:.3g}, predictions {max(d_pred):.3g}", flush=True)


# ----------------------------------------------------------------------
# phases 23-26: the iterative methods and the matrix-free Vecchia-Laplace
class _RefitLog:
    """Records, while entered, every warm-started GD refit of the
    covariance parameters that a LaGaBoost round runs
    (gpboost_tpu_torch.boosting.gbdt's gd_fit_laplace_engine): per refit
    its GD iterations, final learning rate, parameters and NLL, the NLL
    and gradient evaluations it made, its seconds and the CG solves of
    its evaluations (the engine's cg_stats accumulator, copied on the
    device: the log adds no host read); and in `trace` every evaluation's
    kind, point u and NLL, in order, over all refits."""

    def __init__(self, torch):
        self.torch, self.refits, self.trace = torch, [], []

    def __enter__(self):
        from gpboost_tpu_torch.boosting import gbdt
        self.gbdt, self.fn = gbdt, gbdt.gd_fit_laplace_engine
        gbdt.gd_fit_laplace_engine = self._refit
        return self

    def __exit__(self, *exc):
        self.gbdt.gd_fit_laplace_engine = self.fn

    def _refit(self, eng, *a, **k):
        ev, nll_fn, grad_fn = {"nll": 0, "grad": 0}, eng.laplace_nll, \
            eng.laplace_grad

        def nll(u, *x):
            v, b = nll_fn(u, *x)
            ev["nll"] += 1
            self.trace.append(("nll", np.array(u), v))
            return v, b

        def grad(u, *x):
            g, b = grad_fn(u, *x)
            ev["grad"] += 1
            self.trace.append(("grad", np.array(u), None))
            return g, b

        def acc():
            return None if eng._cg_acc is None else eng._cg_acc.clone()

        cg0 = acc()
        eng.laplace_nll, eng.laplace_grad = nll, grad
        t0 = time.perf_counter()
        try:
            # the refit ends on host reads of its NLL: no sync is needed
            out = self.fn(eng, *a, **k)
        finally:
            del eng.laplace_nll, eng.laplace_grad
        self.refits.append({"it": out[4], "lr": out[3], "pars": out[0],
                            "nll": out[2], "evals": ev, "cg": (cg0, acc()),
                            "secs": time.perf_counter() - t0})
        return out

    def lines(self):
        out = []
        for i, r in enumerate(self.refits):
            a, b = r["cg"]
            cg = [0, 0, 0] if b is None else (
                b if a is None else b - a).tolist()
            out.append(
                f"refit {i + 1}: {r['it']} GD iterations, "
                f"{r['evals']['nll']} NLL and {r['evals']['grad']} gradient "
                f"evaluations, {r['secs']:.3f} s, lr {r['lr']:.6g}, cov pars "
                f"{np.asarray(r['pars']).tolist()}, nll {r['nll']:.10f}, CG "
                f"{cg[1]} iterations in {cg[0]} columns ({cg[2]} at maxit)")
        return out


def _first_parting(ta, tb, u_tol=1e-4):
    """(index, largest relative NLL difference before it) of the first
    evaluation at which two refit traces part: another kind of
    evaluation, or a point u that differs by more than u_tol relative to
    its largest entry (a GD step taken at another length; the same steps
    differ by the gradients' CG-level error, ~1e-6); index None when they
    never part."""
    worst = 0.0
    for i, ((ka, ua, va), (kb, ub, vb)) in enumerate(zip(ta, tb)):
        if ka != kb or np.max(np.abs(ua - ub)) > u_tol * np.max(np.abs(ub)):
            return i, worst
        if va is not None:
            worst = max(worst, abs(va / vb - 1.0))
    if len(ta) != len(tb):
        return min(len(ta), len(tb)), worst
    return None, worst


def _spd(n, seed):
    """A small SPD matrix with a spread spectrum, its Jacobi diagonal."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    G = M @ M.T / n + np.diag(0.5 + rng.rand(n))
    return G, rng


def phase_iterative_pieces(torch, gpt):
    """The primitives of ops/iterative.py and the Vecchia operators, card
    against CPU: pcg (tol 1e-10), pcg_it's per-column counts, pcg_batched,
    an SLQ log-determinant and its gradient, the pivoted Cholesky on a
    200 x 200 SPD operator (rtol 1e-9, counts equal); B v and B'w at
    n = 2,000 against B built densely (1e-12 of the largest entry, one
    column and 8), B'w bitwise equal across two launches."""
    from gpboost_tpu_torch.ops import iterative as it
    nq = 200
    G, rng = _spd(nq, SEED)
    b, B = rng.randn(nq), rng.randn(nq, 6)
    coords = rng.rand(nq, 2)
    out = {}
    for dev in ("cuda", "cpu"):
        Gd = torch.as_tensor(G, device=dev)
        dg = torch.diagonal(Gd)

        def mv(v):
            return Gd @ v

        def pre(r):
            return r / (dg if r.ndim == 1 else dg[:, None])

        bd, Bd = (torch.as_tensor(a, device=dev) for a in (b, B))
        x = it.pcg(mv, bd, pre, tol=1e-10)
        X, its = it.pcg_it(mv, Bd, pre, tol=1e-8)
        Xb = it.pcg_batched(mv, Bd.T, None, tol=1e-8)
        slq = it.make_slq_logdet(lambda th, v: Gd @ v + torch.exp(th[0]) * v,
                                 nq, rank=40, num_probes=20, seed=3,
                                 device=dev)
        th = torch.tensor([0.3], dtype=torch.float64, device=dev,
                          requires_grad=True)
        val = slq(th)
        (g,) = torch.autograd.grad(val, th)
        L, drem = it.pivoted_cholesky_kernel(
            torch.as_tensor(coords, device=dev), 1.3,
            lambda d: torch.exp(-d / 0.2), 25)
        out[dev] = [t.detach().cpu().numpy() for t in
                    (x, X, its, Xb, val, g, L, drem)]
    names = ("pcg", "pcg_it x", "pcg_it counts", "pcg_batched", "slq value",
             "slq gradient", "pivoted cholesky L", "pivoted cholesky d")
    errs = {}
    for nm, a, c in zip(names, out["cuda"], out["cpu"]):
        if nm == "pcg_it counts":
            if not np.array_equal(a, c):
                raise AssertionError(f"iterative pieces: {nm} {a} vs {c}")
            continue
        errs[nm] = float(np.max(np.abs(a - c)) / max(np.max(np.abs(c)),
                                                     1e-300))
    if not max(errs.values()) < 1e-9:
        raise AssertionError(f"iterative pieces card vs CPU: {errs}")
    ex = np.linalg.solve(G, b)
    if not np.max(np.abs(out["cuda"][0] - ex)) < 1e-8 * np.max(np.abs(ex)):
        raise AssertionError("pcg against a dense solve")
    # the Vecchia operators at n = 2,000
    n_b = 2_000
    coords, y = sim_vl(n_b)
    eng = gpt.GPModel(gp_coords=coords, dtype="float64", device="cuda",
                      **VL_ITER)._engine
    with torch.no_grad():
        A, D = eng._vecchia._bd(eng._t(np.log([0.9, 10.0])), latent=True)
        idx = eng._vecchia._nn_idx
        An, In = A.cpu().numpy(), idx.cpu().numpy()
        Bm = np.eye(n_b)
        np.add.at(Bm, (np.repeat(np.arange(n_b), In.shape[1]),
                       In.reshape(-1)), -An.reshape(-1))
        op_err = 0.0
        bitwise = True
        for k in (None, 8):
            V = rng.randn(n_b) if k is None else rng.randn(n_b, k)
            Vd = eng._t(V)
            for name, f, ref in (("Bv", eng._Bv, Bm @ V),
                                 ("B'w", eng._Btv, Bm.T @ V)):
                r1, r2 = f(A, Vd), f(A, Vd)
                op_err = max(op_err, float(np.max(np.abs(
                    r1.cpu().numpy() - ref)) / np.max(np.abs(ref))))
                bitwise &= bool(torch.equal(r1, r2))
    if not (op_err < 1e-12 and bitwise):
        raise AssertionError(f"vecchia operators: max rel err {op_err}, "
                             f"bitwise {bitwise}")
    print("[iterative pieces] card vs CPU, max rel diff: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; pcg_it counts {out["cuda"][2].tolist()} both; Vecchia B v "
          f"and B'w at n={n_b} (1 and 8 columns) against B built "
          f"densely: max rel err {op_err:.3g}, B'w bitwise equal across "
          "two launches", flush=True)


def _operator_times(torch, eng, u, y, b):
    """ms per vadu CG iteration, per S_J application (one column) and per
    Lanczos step (the SLQ value over num_rand_vec_trace probes / 50), each
    with its byte bound, at the engine's size and the parameters u."""
    n, m = eng.n, eng._vecchia.m
    with torch.no_grad():
        ud = eng._t(u)
        th, aux = eng._split_u(ud)
        A, D = eng._vecchia._bd(th, latent=True)
        yv, Fv = eng._to_vecchia(eng.prep_y(y)), eng.zero_mode()
        _, W = eng._d1_W(yv, b + Fv, aux, eng._fisher_det, False)
        v = eng._t(np.random.RandomState(SEED).randn(n))
        _, its = eng._solve_qw(A, D, W, v, th)
        its = int(its)
        cg_ms = _time_ms(torch, lambda: eng._solve_qw(A, D, W, v, th),
                         reps=3) / its
        sj_ms = _time_ms(torch, lambda: eng._SJ(A, v), reps=10)
        slq = eng._slq()
        rank = min(eng.n, 50)
        lz_ms = _time_ms(torch, lambda: slq(A, D, W), reps=2) / rank
        # B'w over the probes' columns: the engine's weighted bags against
        # SegmentSum (the grouped engines' deterministic sum) of the formed
        # (n m, k) products
        from gpboost_tpu_torch.models.grouped_re import SegmentSum
        k = eng.num_rand_vec_trace
        T = eng._t(np.random.RandomState(SEED).randn(n, k))
        seg = SegmentSum(eng._nb._flat_idx.cpu().numpy(), n, eng.device)

        def bw_seg():
            return T - seg((A[:, :, None] * T[:, None, :]).reshape(-1, k))

        bw_ms = _time_ms(torch, lambda: eng._Btv(A, T), reps=10)
        bw_seg_ms = _time_ms(torch, bw_seg, reps=10)
        bw_err = float((eng._Btv(A, T) - bw_seg()).abs().max()
                       / bw_seg().abs().max())
        if not bw_err < 1e-12:
            raise AssertionError(f"B'w: bags against SegmentSum {bw_err}")
    isz = torch.finfo(eng.dtype).bits // 8

    def pass_bytes(cols):
        # index and coefficient per slot, base and operand read, result
        return n * m * (8 + isz) + 3 * n * cols * isz

    b_sj = bound(32 * pass_bytes(1), 32 * 2 * n * m)
    b_cg = bound(66 * pass_bytes(1) + 12 * n * isz, 66 * 2 * n * m)
    b_lz = bound(66 * pass_bytes(k) + 12 * n * k * isz, 66 * 2 * n * m * k)
    eng.cg_stats(reset=True)
    return {"cg_iteration_ms": cg_ms, "cg_its": its, "sj_ms": sj_ms,
            "lanczos_step_ms": lz_ms, "bound_cg_ms": b_cg[0],
            "bound_sj_ms": b_sj[0], "bound_lanczos_ms": b_lz[0],
            "bw_ms": bw_ms, "bw_segment_sum_ms": bw_seg_ms,
            "bound_bw_ms": bound(pass_bytes(k), 2 * n * m * k)[0], "k": k}


def _fmt_ops(t):
    return (f"vadu CG iteration {t['cg_iteration_ms']:.3f} ms (bound "
            f"{t['bound_cg_ms']:.4f}; {t['cg_its']} iterations), S_J on one "
            f"column {t['sj_ms']:.3f} ms (bound {t['bound_sj_ms']:.4f}), "
            f"Lanczos step over the probes {t['lanczos_step_ms']:.3f} ms "
            f"(bound {t['bound_lanczos_ms']:.4f}); B'w over {t['k']} columns "
            f"{t['bw_ms']:.4f} ms by the weighted bags, "
            f"{t['bw_segment_sum_ms']:.4f} ms by SegmentSum of the formed "
            f"products (bound {t['bound_bw_ms']:.4f})")


def phase_vecchia_laplace_iterative(torch, gpt, cov_dense64):
    """The reference's vecchia_laplace_n20k as it runs it
    (bench_reference.py:229-236): sim_vl n = 20,000, seed 3,
    bernoulli_probit, exponential, 20 neighbours, iterative with vadu,
    float64, maxit 20, init_cov_pars [1.0, 0.1]. One fit (a second after
    reset_fit was cut for phases 27-29): seconds, iterations, Newton
    steps, CG iterations
    (mode finding, and every solve with the SLQ probes'), host syncs, peak
    device memory; no float64 solve may stop at cg_max_num_it. Device busy
    share of one NLL-and-gradient evaluation at the estimate
    (torch.profiler); the operator's times; the covariance parameters
    against phase 20's dense float64 fit (rtol 1e-1, the R suite's
    TOL_ITERATIVE); then one float32 fit with its solves at maxit."""
    coords, y = sim_vl(N_VL)
    model = gpt.GPModel(gp_coords=coords, dtype="float64", device="cuda",
                        **VL_ITER)
    eng = model._engine
    rows = []
    for label in ("first fit",):
        eng.total_num_mode_it = eng.total_num_cg_it = 0
        eng.cg_stats(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, syncs = _count_syncs(torch, lambda: model.fit(y=y,
                                                         params=VL_FIT))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cg = eng.cg_stats(reset=True)
        r = model._fit_result
        rows.append((label, secs, r.num_it, eng.total_num_mode_it,
                     eng.total_num_cg_it, cg, syncs,
                     torch.cuda.max_memory_allocated() / 2 ** 30))
        if cg["at_maxit"]:
            raise AssertionError(f"vecchia-laplace iterative {label}: "
                                 f"{cg['at_maxit']} float64 CG solves "
                                 "stopped at cg_max_num_it")
    cov = model.get_cov_pars()
    rel = float(np.max(np.abs(cov / cov_dense64 - 1.0)))
    if not (np.all(np.isfinite(cov)) and rel < 1e-1
            and 0 < model.get_num_optim_iter() <= MAXIT_VL):
        raise AssertionError(f"vecchia-laplace iterative: cov pars {cov} "
                             f"against the dense fit's {cov_dense64}")
    r = model._fit_result
    u = np.log(eng.transform_pars(r.cov_pars))
    kernels = {}
    busy, wall, _ = _device_busy_s(torch, lambda: eng.laplace_vag(
        u, y, np.zeros(N_VL), r.mode_state), by_name=kernels)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    ops = _operator_times(torch, eng, u, y, r.mode_state)
    for label, secs, nit, newton, cgm, cg, syncs, peak in rows:
        print(f"[vecchia-laplace iterative] n={N_VL} m={M_VL} vadu float64 "
              f"{label}: {secs:.3f} s, {nit} iterations ({r.optimizer}), "
              f"{newton} Newton steps, {cgm} CG iterations in the mode "
              f"finding, {cg['iterations']} in all {cg['solves']} solved "
              f"columns ({cg['at_maxit']} at cg_max_num_it), {syncs} host "
              f"syncs, peak device memory {peak:.2f} GiB", flush=True)
    print(f"[vecchia-laplace iterative] one NLL and gradient at the "
          f"estimate: device busy {_busy_txt(busy, wall)}; by kernel: "
          + "; ".join(f"{k[:60]} {v:.3f} s" for k, v in top), flush=True)
    print(f"[vecchia-laplace iterative] n={N_VL}: {_fmt_ops(ops)}",
          flush=True)
    print(f"[vecchia-laplace iterative] cov pars {cov.tolist()}, nll "
          f"{r.neg_log_likelihood:.4f}; the dense float64 fit's "
          f"{cov_dense64.tolist()}: max rel diff {rel:.3g}", flush=True)
    ref = _reference_time("vecchia_laplace_fit_n20k_binary")
    if ref is not None:
        print(f"[vecchia-laplace iterative] the reference C++ library, "
              f"iterative float64 (BASELINE_MEASURED.json, "
              f"bench_reference.py:229-236, {ref[2]} CPU thread(s)): "
              f"{ref[0]} s, {ref[1]} iterations", flush=True)
    del model, eng
    torch.cuda.empty_cache()
    m32 = gpt.GPModel(gp_coords=coords, dtype="float32", device="cuda",
                      **VL_ITER)
    t0 = time.perf_counter()
    m32.fit(y=y, params={**VL_FIT, "maxit": MAXIT_VL32})
    torch.cuda.synchronize()
    secs32 = time.perf_counter() - t0
    cg32 = m32._engine.cg_stats()
    cov32 = m32.get_cov_pars()
    print(f"[vecchia-laplace iterative] float32 (maxit {MAXIT_VL32}): "
          f"{secs32:.3f} s, "
          f"{m32.get_num_optim_iter()} iterations, "
          f"{m32._engine.total_num_mode_it} Newton steps, "
          f"{m32.get_total_num_cg_steps()} CG iterations in the mode "
          f"finding, {cg32['iterations']} in all {cg32['solves']} solved "
          f"columns, {cg32['at_maxit']} of them at cg_max_num_it; cov pars "
          f"{cov32.tolist()} (max rel diff to float64 "
          f"{float(np.max(np.abs(cov32 / cov - 1.0))):.3g})", flush=True)
    return rows


def phase_vecchia_lagaboost_iterative(torch, gpt, histogram, kernel_row,
                                      maxit=MAXIT_VLB_ITER):
    """hist_segment at n = 50,000, p = 5 (phase 3's checks and times);
    then binary Vecchia LaGaBoost at the reference's n = 50,000
    (sim_lagab, p = 5, seed 4; bench_reference.py:90-99, :190-203):
    exponential, 20 neighbours, bernoulli_probit, iterative, float64, 31
    leaves, learning rate 0.1. Depth is cut so that the script stays
    inside 900 s: 2 rounds (the reference runs 10), the GP model's first
    fit capped at `maxit` iterations (MAXIT_VLB_ITER; --vlb-maxit 0 lifts
    the cap). Init-score and first-fit seconds, seconds per round with
    each round's GD refit (iterations, NLL and gradient evaluations,
    seconds, CG), host syncs of the second (steady) round, device busy
    share of one gradient (torch.profiler), CG totals (no float64 solve
    at cg_max_num_it), peak device memory (below one n x n float64
    matrix), the operator's times; then the response on 1,000 new points
    with 500 simulation draws. Returns hist_segment's launches over the 2
    rounds."""
    phase_segment_vl(torch, gpt, histogram, kernel_row, n_rows=N_VLB_ITER)
    _reset_launches(histogram)
    torch.cuda.reset_peak_memory_stats()
    with _RefitLog(torch) as log:
        bst, gp, init_s, fit_s, secs = _train_vl_lagaboost(
            torch, gpt, N_VLB_ITER, "cuda", "float64", 1, model=VL_ITER,
            gp_params={"maxit": maxit} if maxit else None)
        from collections import Counter
        sites = Counter()
        t0 = time.perf_counter()
        _, syncs = _count_syncs(torch, bst.update, sites)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    eng = gp._engine
    launches = histogram.hist_segment.launches
    cg = eng.cg_stats(reset=True)
    print("[vecchia-lagaboost iterative] host syncs of round 2 by Python "
          "line: " + ", ".join(f"{k} x{v}" for k, v in
                               sites.most_common(6)), flush=True)
    for line in log.lines():
        print(f"[vecchia-lagaboost iterative] {line}", flush=True)
    r = gp._fit_result
    u = eng._u_from_pars(r.cov_pars, r.aux_pars, gp.y)
    busy, wall, _ = _device_busy_s(torch, lambda: eng.vag_F_device(
        u, bst.y, bst.F, r.mode_state, value=False))
    ops = _operator_times(torch, eng, u, gp.y, r.mode_state)
    rng = np.random.RandomState(SEED_VLB + 1)
    Xn, cn = rng.rand(N_PRED, P_VLB), rng.rand(N_PRED, 2)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pred_s = time.perf_counter() - t0
    cg_pred = eng.cg_stats(reset=True)
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"vecchia lagaboost iterative: {k}")
    if not (np.all(pred["response_mean"] > 0)
            and np.all(pred["response_mean"] < 1)):
        raise AssertionError("vecchia lagaboost iterative: probabilities "
                             "outside (0, 1)")
    cov = gp.get_cov_pars()
    at_maxit = cg["at_maxit"] + cg_pred["at_maxit"]
    # no step may hold an n x n matrix (8 n^2 bytes in float64)
    peak = torch.cuda.max_memory_allocated()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)
            and launches > 0 and at_maxit == 0
            and peak < 8 * N_VLB_ITER ** 2):
        raise AssertionError(f"vecchia lagaboost iterative: cov pars {cov}, "
                             f"{launches} hist_segment launches, "
                             f"{at_maxit} CG solves at cg_max_num_it, peak "
                             f"device memory {peak / 2 ** 30:.2f} GiB")
    cap = f"maxit {maxit}" if maxit else "uncapped"
    print(f"[vecchia-lagaboost iterative] n={N_VLB_ITER} p={P_VLB} m={M_VL} "
          f"bernoulli_probit iterative vadu float64, 2 rounds: booster "
          f"with init score {init_s:.3f} s (init score "
          f"{bst.init_score:.5f}); first GP fit {fit_s:.3f} s, "
          f"{r.num_it} iterations ({r.optimizer}, {cap}); per round "
          f"{', '.join(f'{x:.3f}' for x in secs)} s, {syncs} host syncs in "
          f"round 2; device busy over one gradient "
          f"{_busy_txt(busy, wall)}; CG over the booster and 2 rounds "
          f"{cg['iterations']} iterations in {cg['solves']} solved columns "
          f"({gp.get_total_num_cg_steps()} in the mode finding over the "
          f"whole run), {at_maxit} at cg_max_num_it; predict {N_PRED} "
          f"points with {eng.nsim_var_pred} draws {pred_s:.3f} s "
          f"({cg_pred['solves']} columns, {cg_pred['iterations']} CG "
          f"iterations); peak device memory {peak / 2 ** 30:.2f} GiB (an "
          f"n x n float64 matrix: {8 * N_VLB_ITER ** 2 / 2 ** 30:.1f} GiB); "
          f"cov pars {cov.tolist()}; hist_segment launches over the 2 "
          f"rounds {launches}", flush=True)
    print(f"[vecchia-lagaboost iterative] n={N_VLB_ITER}: {_fmt_ops(ops)}",
          flush=True)
    ref = _reference_time("lagaboost_binary_vecchia_n50k_10rounds")
    if ref is not None:
        print(f"[vecchia-lagaboost iterative] the reference C++ library, "
              f"10 rounds iterative float64 (BASELINE_MEASURED.json, "
              f"{ref[2]} CPU thread(s)): {ref[0]} s", flush=True)
    return launches


def phase_iterative_card_vs_cpu(torch, gpt):
    """Card against CPU at n = N_IT_CPU (500), iterative (vadu), float64,
    with 5 probes (num_rand_vec_trace) and at most 2 iterations a fit
    (maxit; n = 2,000, 10 probes and 3 before phases 39-41 came, then
    n = 1,000),
    set by set_optim_params to keep the CPU side short: the engine's NLL
    (rtol 1e-6), g_u and g_F (rtol 1e-4) and Newton steps; one fit
    (parameters rtol 1e-3, equal iterations); 2 LaGaBoost rounds with the
    default per-round GD refit of the covariance parameters (the refit
    after the last round, which feeds no tree, is skipped), each refit's
    GD iterations, evaluations, parameters and CG printed for both sides.
    Where the two refits take the same steps (every evaluation at points
    within 1e-4 of each other), GD iterations and step lengths are equal,
    parameters agree to rtol 1e-4 and NLLs to 1e-8 (the first run read
    1.5e-6 and 1.8e-10: the probe solves' CG error), and both trees
    follow phase 5's near-tie rule, predictions to 1e-4; where they part,
    the parting must be a GD decision taken on NLLs that agreed to 1e-8,
    and only the tree before it is compared. Then
    the grouped iterative branch at q = 25,000 (n = 100,000, crossed
    groupings of 20,000 and 5,000 levels), which auto takes, against the
    Cholesky branch on the card: NLL (rtol 1e-4) and its gradient (1e-1,
    the R suite's TOL_ITERATIVE: the SLQ gradient's error) at fixed
    parameters, and a fit (1e-2)."""
    coords, y = sim_vl(N_IT_CPU)
    F = 0.3 * np.sin(np.arange(N_IT_CPU))
    u = np.log([0.9, 1.0 / 0.1])
    it_params = {"num_rand_vec_trace": 5, "maxit": 2}
    ev = {}
    for dev in ("cuda", "cpu"):
        gm = gpt.GPModel(gp_coords=coords, dtype="float64", device=dev,
                         **VL_ITER)
        gm.set_optim_params(params=it_params)
        eng = gm._engine
        t0 = time.perf_counter()
        nll, gu, gF, _ = eng.laplace_vag_F(u, y, F, eng.zero_mode())
        ev[dev] = (nll, gu, gF, eng.last_num_mode_it, eng.last_num_cg_it,
                   time.perf_counter() - t0)
    (ng, gug, gFg, sg, cgg, tg), (nc, guc, gFc, sc, cgc, tc) = \
        ev["cuda"], ev["cpu"]
    errs = {"nll": abs(ng / nc - 1.0),
            "g_u": float(np.max(np.abs(gug / guc - 1.0))),
            "g_F": float(np.max(np.abs(gFg - gFc)) / np.max(np.abs(gFc)))}
    print(f"[iterative card-vs-cpu] n={N_IT_CPU} m={M_VL} vadu float64, 5 "
          "probes: engine max rel diff " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f", Newton steps {sg} / {sc}, CG iterations {cgg} / {cgc} "
          f"(card {tg:.3f} s, cpu {tc:.3f} s)", flush=True)
    if not (errs["nll"] < 1e-6 and max(errs["g_u"], errs["g_F"]) < 1e-4
            and sg == sc):
        raise AssertionError(f"iterative engine card vs CPU: {errs}, "
                             f"Newton steps {sg} vs {sc}")
    fits = {}
    for dev in ("cuda", "cpu"):
        gm = gpt.GPModel(gp_coords=coords, dtype="float64", device=dev,
                         **VL_ITER)
        t0 = time.perf_counter()
        gm.fit(y=y, params={**VL_FIT, **it_params})
        fits[dev] = (gm.get_cov_pars(), gm.get_num_optim_iter(),
                     time.perf_counter() - t0)
    fit_rel = float(np.max(np.abs(fits["cuda"][0] / fits["cpu"][0] - 1.0)))
    print(f"[iterative card-vs-cpu] fit (maxit 2): cov pars max rel diff "
          f"{fit_rel:.3g}, iterations {fits["cuda"][1]} / {fits['cpu'][1]} "
          f"(card {fits["cuda"][2]:.3f} s, cpu {fits['cpu'][2]:.3f} s)",
          flush=True)
    if not (fit_rel < 1e-3 and fits["cuda"][1] == fits["cpu"][1]):
        raise AssertionError(f"iterative fit card vs CPU: {fits}")
    # LaGaBoost with the default per-round refit: round 1 (the first fit,
    # tree 1, the GD refit), round 2 (tree 2 from the refit; the refit
    # after it feeds no tree and is skipped)
    runs, logs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with _RefitLog(torch) as logs[dev]:
            bst, gp, *_ = _train_vl_lagaboost(
                torch, gpt, N_IT_CPU, dev, "float64", 1, model=VL_ITER,
                gp_params=it_params)
            bst.params["train_gp_model_cov_pars"] = False
            bst.update()
        runs[dev] = (bst, gp, gp.get_total_num_cg_steps(),
                     time.perf_counter() - t0)
    for dev in ("cuda", "cpu"):
        for line in logs[dev].lines():
            print(f"[iterative card-vs-cpu] LaGaBoost {dev} {line}; mode "
                  f"finding CG over the run {runs[dev][2]}", flush=True)
    bg, bc = runs["cuda"][0], runs["cpu"][0]
    part, nll_gap = _first_parting(logs["cuda"].trace, logs["cpu"].trace)
    rg, rc = logs["cuda"].refits[0], logs["cpu"].refits[0]
    if part is None:
        # the refits took the same steps; their parameters agree to the
        # level of the gradients' CG error (the probe solves stop at a
        # relative residual of 1e-6), and both trees are compared
        rel = float(np.max(np.abs(rg["pars"] / rc["pars"] - 1.0)))
        if not (rg["it"] == rc["it"] and rg["lr"] == rc["lr"]
                and rel < 1e-4 and nll_gap < 1e-8):
            raise AssertionError(f"iterative lagaboost refit card vs CPU: "
                                 f"{rg} vs {rc}")
        res = _compare_models("iterative lagaboost card-vs-cpu", bc, bg)
        what = (f"the refits took the same {rg['it']} GD steps (parameters "
                f"max rel diff {rel:.3g}, NLLs {nll_gap:.3g}); trees {res}")
    else:
        # the runs parted at a discrete GD decision (an Armijo test or the
        # convergence test) taken on NLLs that agreed to 1e-8: a tie at the
        # level of the gradients' CG error; the tree before it must agree,
        # the one after it is not compared
        kind, ug, vg = logs["cuda"].trace[part]
        _, uc, vc = logs["cpu"].trace[part]
        print(f"[iterative card-vs-cpu] LaGaBoost: the refits part at "
              f"evaluation {part} ({kind}) at u {ug.tolist()} (card) vs "
              f"{uc.tolist()} (cpu); before it every NLL agreed to "
              f"{nll_gap:.3g}; the evaluations before: " + "; ".join(
                  f"{k} {v!r} / {w!r}" for (k, _, v), (_, _, w) in zip(
                      logs["cuda"].trace[max(part - 3, 0):part],
                      logs["cpu"].trace[max(part - 3, 0):part])),
              flush=True)
        if not (part > 0 and nll_gap < 1e-8):
            raise AssertionError("iterative lagaboost card vs CPU: the "
                                 "refits part at evaluation "
                                 f"{part} on NLLs {nll_gap:.3g} apart")
        from types import SimpleNamespace
        res = _compare_models("iterative lagaboost card-vs-cpu",
                              *(SimpleNamespace(trees=b_.trees[:1])
                                for b_ in (bc, bg)))
        what = f"tree 1 {res}; tree 2 follows the parted refit"
    rng = np.random.RandomState(SEED_VLB + 2)
    Xn, cn = rng.rand(200, P_VLB), rng.rand(200, 2)
    perr = {}
    if part is None and res != "near tie":
        perr["training score"] = float((bg.F.cpu() - bc.F).abs().max())
        pg = bg.predict(Xn, gp_coords_pred=cn, predict_var=True)
        pc = bc.predict(Xn, gp_coords_pred=cn, predict_var=True)
        for k in ("response_mean", "response_var"):
            perr[k] = float(np.max(np.abs(pg[k] - pc[k])))
    print(f"[iterative card-vs-cpu] LaGaBoost 2 rounds, refit on: {what}; "
          "max |diff| " + (", ".join(f"{k} {v:.3g}" for k, v in perr.items())
                           or "not compared")
          + f" (card {runs['cuda'][-1]:.3f} s, cpu {runs['cpu'][-1]:.3f} s)",
          flush=True)
    if perr and not max(perr.values()) < 1e-4:
        raise AssertionError(f"iterative lagaboost card vs CPU: {perr}")
    # the grouped iterative branch, where auto takes it (q > 20,000)
    rng = np.random.RandomState(SEED)
    q1 = Q_GROUPED_ITER * 4 // 5
    group = np.column_stack([
        rng.randint(0, q1, N_GROUPED_ITER),
        rng.randint(0, Q_GROUPED_ITER - q1, N_GROUPED_ITER)])
    yq = 0.7 * rng.randn(q1)[group[:, 0]] \
        + 0.5 * rng.randn(Q_GROUPED_ITER - q1)[group[:, 1]] \
        + rng.randn(N_GROUPED_ITER)
    out = {}
    for mim in ("auto", "cholesky"):
        gm = gpt.GPModel(group_data=group, device="cuda",
                         matrix_inversion_method=mim)
        eng = gm._engine
        yd = eng.prep_y(yq)
        th = eng._t(np.log([0.5, 0.25])).requires_grad_(True)
        t0 = time.perf_counter()
        nll, _ = eng._nll_parts(th, eng._t(1.0), yd)
        (g,) = torch.autograd.grad(nll, th)
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gm.fit(y=yq)
        torch.cuda.synchronize()
        out[mim] = (eng.matrix_inversion_method, float(nll),
                    g.detach().cpu().numpy(),
                    gm.get_cov_pars(), gm.get_num_optim_iter(), ev_s,
                    time.perf_counter() - t0)
    (mi, ni, gi, ci, ii, ei, fi), (mc, nc_, gc, cc, ic, ec, fc) = \
        out["auto"], out["cholesky"]
    gerr = {"nll": abs(ni / nc_ - 1.0),
            "gradient": float(np.max(np.abs(gi / gc - 1.0))),
            "cov pars": float(np.max(np.abs(ci / cc - 1.0)))}
    if not (mi == "iterative" and gerr["nll"] < 1e-4
            and gerr["gradient"] < 1e-1 and gerr["cov pars"] < 1e-2):
        raise AssertionError(f"grouped iterative vs cholesky: {mi}, {gerr}")
    print(f"[grouped iterative] n={N_GROUPED_ITER} q={Q_GROUPED_ITER}: auto "
          f"takes '{mi}'; against the Cholesky branch max rel diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in gerr.items())
          + f"; NLL and gradient {ei:.3f} s (Cholesky {ec:.3f} s), fit "
          f"{fi:.3f} s and {ii} iterations (Cholesky {fc:.3f} s, {ic})",
          flush=True)


# ----------------------------------------------------------------------
# phases 27-29: the rest of the Gaussian Vecchia engine, weights and
# cluster_ids in the Gaussian engines, Nesterov-accelerated GPBoost
VECCHIA_PRED_TYPES = ("order_obs_first_cond_obs_only", "order_pred_first",
                      "latent_order_obs_first_cond_obs_only",
                      "order_obs_first_cond_all",
                      "latent_order_obs_first_cond_all")
LATENT_ALL = "latent_order_obs_first_cond_all"
N_PRED_VECCHIA, N_LATENT_VAR, N_PRED_VCPU = 10_000, 200, 200
VECCHIA_FIT = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.5, 1.0, 0.1],
               "maxit": MAXIT_VECCHIA}
N_CLUSTERS, N_PER_CLUSTER, N_DENSE_CL, DENSE_CLUSTERS = 100, 1_000, 5_000, 10
ROUNDS_CPU_27_29 = 5


def _vecchia_model(gpt, coords, dtype, device, **kw):
    """The headline's model (phase 14): exponential, 20 neighbours, random
    ordering."""
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       gp_approx="vecchia", num_neighbors=20,
                       vecchia_ordering="random", dtype=dtype,
                       device=device, **kw)


def _weights(n):
    """Observation weights 0.5 + 2u, u from the script's LCG."""
    return 0.5 + 2.0 * lcg_unif(n, 0.55)


def _timed(torch, fn):
    """(fn(), seconds, host syncs, peak device GiB) of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, syncs = _count_syncs(torch, fn)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, syncs,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _finite(what, arr, shape, positive=False):
    arr = np.asarray(arr)
    if arr.shape != shape or not np.all(np.isfinite(arr)) \
            or (positive and not np.all(arr > 0)):
        raise AssertionError(f"{what}: shape {arr.shape}, not all finite"
                             + (" and positive" if positive else ""))


def _rel_max(a, b):
    """max |a - b| over max |b|."""
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def phase_vecchia_pred(torch, gpt):
    """The headline's model in float64, fitted on the device L-BFGS, then
    every prediction ordering at 10,000 new points (latent variances at
    N_LATENT_VAR), the training random effects, one float32 latent solve, and the
    orderings card against CPU at n = 2,000."""
    coords, y = sim_vecchia(N_VECCHIA)
    t0 = time.perf_counter()
    model = _vecchia_model(gpt, coords, "float64", "cuda")
    setup_s = time.perf_counter() - t0
    _, fit_s, fit_syncs, _ = _timed(torch, lambda: model.fit(
        y=y, params=VECCHIA_FIT))
    r = model._fit_result
    pars = model.get_cov_pars()
    if r.optimizer != "device_lbfgs":
        raise AssertionError(f"vecchia-pred fit took the {r.optimizer} path")
    _finite("vecchia-pred cov pars", pars, (3,), positive=True)
    print(f"[vecchia-pred] n={N_VECCHIA} m=20 float64: engine setup "
          f"{setup_s:.3f} s, fit {fit_s:.3f} s in {r.num_it} device L-BFGS "
          f"iterations, {fit_syncs} host syncs; cov pars {pars.tolist()}",
          flush=True)
    eng = model._engine
    cp = np.random.RandomState(SEED + 7).rand(N_PRED_VECCHIA, 2)
    for vt in VECCHIA_PRED_TYPES:
        latent = vt == LATENT_ALL
        model.set_prediction_data(vecchia_pred_type=vt)
        pred, secs, syncs, peak = _timed(torch, lambda: model.predict(
            gp_coords_pred=cp, predict_var=not latent))
        _finite(f"{vt} mean", pred["mu"], (N_PRED_VECCHIA,))
        txt = ""
        if latent:
            cg = int(eng.last_pred_cg_it.max())
            again = model.predict(gp_coords_pred=cp)["mu"]
            if not np.array_equal(again, pred["mu"]):
                raise AssertionError("latent mean: two launches differ")
            pv, vsecs, vsyncs, vpeak = _timed(torch, lambda: model.predict(
                gp_coords_pred=cp[:N_LATENT_VAR], predict_var=True))
            _finite(f"{vt} variances", pv["var"], (N_LATENT_VAR,),
                    positive=True)
            txt = (f"; mean CG {cg} iterations, bitwise equal in a second "
                   f"launch; variances at {N_LATENT_VAR} points {vsecs:.3f} "
                   f"s, {vsyncs} host syncs, CG "
                   f"{int(eng.last_pred_cg_it.max())} iterations, peak "
                   f"{vpeak:.2f} GiB")
        else:
            _finite(f"{vt} variances", pred["var"], (N_PRED_VECCHIA,),
                    positive=True)
        what = "means" if latent else "means and variances"
        print(f"[vecchia-pred] {vt}: {what} at {N_PRED_VECCHIA} points "
              f"{secs:.3f} s, {syncs} host syncs, peak {peak:.2f} GiB{txt}",
              flush=True)
    re_, secs, syncs, peak = _timed(
        torch, model.predict_training_data_random_effects)
    _finite("training random effects", re_["GP_1"], (N_VECCHIA,))
    print(f"[vecchia-pred] predict_training_data_random_effects n="
          f"{N_VECCHIA}: {secs:.3f} s, {syncs} host syncs, peak {peak:.2f} "
          "GiB", flush=True)
    m32 = _vecchia_model(gpt, coords, "float32", "cuda")
    m32.set_prediction_data(vecchia_pred_type=LATENT_ALL)
    p32, secs, _, _ = _timed(torch, lambda: m32.predict(
        y=y, gp_coords_pred=cp[:N_LATENT_VAR], cov_pars=pars))
    model.set_prediction_data(vecchia_pred_type=LATENT_ALL)
    p64 = model.predict(gp_coords_pred=cp[:N_LATENT_VAR])["mu"]
    _finite("float32 latent mean", p32["mu"], (N_LATENT_VAR,))
    print(f"[vecchia-pred] float32 latent mean at {N_LATENT_VAR} points: CG "
          f"{int(m32._engine.last_pred_cg_it.max())} iterations (maxit "
          f"1000, tol 1e-8 of ||b||), {secs:.3f} s; max |diff| to float64 "
          f"{float(np.max(np.abs(p32['mu'] - p64))):.3g}", flush=True)
    # card against CPU at n = 2,000, at fixed parameters
    coords2, y2 = sim_vecchia(N_CPU, seed=SEED)
    cp2 = np.random.RandomState(SEED + 8).rand(N_PRED_VCPU, 2)
    pars2 = np.array([0.25, 1.0, 0.1])
    ms = {dev: _vecchia_model(gpt, coords2, "float64", dev)
          for dev in ("cuda", "cpu")}
    errs = {}
    for vt in VECCHIA_PRED_TYPES:
        tol = 1e-6 if vt == LATENT_ALL else 1e-8
        out = {}
        for dev, m_ in ms.items():
            m_.set_prediction_data(vecchia_pred_type=vt)
            out[dev] = m_.predict(y=y2, gp_coords_pred=cp2, cov_pars=pars2,
                                  predict_var=True)
        errs[vt] = max(_rel_max(out["cuda"][k], out["cpu"][k])
                       for k in ("mu", "var"))
        if not errs[vt] <= tol:
            raise AssertionError(f"vecchia-pred card vs CPU {vt}: "
                                 f"{errs[vt]:.3g} > {tol}")
    tr = [m_._engine.training_re(pars2, y2)[0] for m_ in ms.values()]
    errs["training_re"] = _rel_max(tr[0], tr[1])
    if not errs["training_re"] <= 1e-8:
        raise AssertionError(f"training_re card vs CPU {errs}")
    print(f"[vecchia-pred card-vs-cpu] n={N_CPU} float64, {N_PRED_VCPU} "
          "points, max |diff| over max |value| of means and variances: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " (tolerance 1e-8; the latent CG 1e-6)", flush=True)


def phase_weights_clusters(torch, gpt, histogram):
    """Weights and cluster_ids at full width: the headline fit with
    weights, a clustered Vecchia fit (100 clusters of 1,000 points), the
    grouped GPBoost of phase 10 with weights, a clustered dense GP at
    n = 5,000. Returns hist_segment's launches of the weighted GPBoost."""
    coords, y = sim_vecchia(N_VECCHIA)
    t0 = time.perf_counter()
    mw = _vecchia_model(gpt, coords, "float32", "cuda",
                        weights=_weights(N_VECCHIA))
    setup_s = time.perf_counter() - t0
    _, secs, syncs, _ = _timed(torch, lambda: mw.fit(y=y,
                                                     params=VECCHIA_FIT))
    r = mw._fit_result
    if r.optimizer != "device_lbfgs":
        raise AssertionError(f"weighted fit took the {r.optimizer} path")
    _finite("weighted cov pars", mw.get_cov_pars(), (3,), positive=True)
    print(f"[weights] headline fit with weights, n={N_VECCHIA} float32: "
          f"setup {setup_s:.3f} s, {r.num_it} device L-BFGS iterations in "
          f"{secs:.3f} s, {syncs} host syncs; cov pars "
          f"{mw.get_cov_pars().tolist()}", flush=True)
    del mw
    rng = np.random.RandomState(SEED + 9)
    loc = rng.rand(N_PER_CLUSTER, 2)
    coords_c = np.tile(loc, (N_CLUSTERS, 1))
    cid = np.repeat(np.arange(N_CLUSTERS), N_PER_CLUSTER)
    yc = np.sin(6 * coords_c[:, 0]) * np.cos(4 * coords_c[:, 1]) \
        + 0.5 * rng.randn(len(cid))
    t0 = time.perf_counter()
    mc = _vecchia_model(gpt, coords_c, "float32", "cuda", cluster_ids=cid)
    setup_s = time.perf_counter() - t0
    e = mc._engine
    own = np.broadcast_to(e._clusters_ord[:, None], e._nn_idx_np.shape)
    mask = e._nn_mask.cpu().numpy()
    if np.any(e._clusters_ord[e._nn_idx_np][mask] != own[mask]):
        raise AssertionError("a conditioning set crosses clusters")
    _, secs, syncs, _ = _timed(torch, lambda: mc.fit(y=yc,
                                                     params=VECCHIA_FIT))
    rc = mc._fit_result
    if rc.optimizer != "device_lbfgs":
        raise AssertionError(f"clustered fit took the {rc.optimizer} path")
    _finite("clustered cov pars", mc.get_cov_pars(), (3,), positive=True)
    print(f"[clusters] Vecchia, {N_CLUSTERS} clusters of {N_PER_CLUSTER} "
          f"points (n={len(cid)}) float32: setup {setup_s:.3f} s (search per "
          f"cluster), no conditioning set crosses a cluster; "
          f"{rc.num_it} device L-BFGS iterations in {secs:.3f} s, {syncs} "
          f"host syncs; cov pars {mc.get_cov_pars().tolist()}", flush=True)
    del mc
    _reset_launches(histogram)
    bst, gp, fit_s, secs = _train_grouped(torch, gpt, N_GROUPED, Q_GROUPED,
                                          "cuda",
                                          weights=_weights(N_GROUPED))
    launches = histogram.hist_segment.launches
    _, syncs = _count_syncs(torch, bst.update)
    Xn, gn = _grouped_new_rows(Q_GROUPED)
    pred = bst.predict(Xn, group_data_pred=gn, predict_var=True)
    _finite("weighted GPBoost response variances", pred["response_var"],
            (len(Xn),), positive=True)
    if launches <= 0:
        raise AssertionError(f"weighted GPBoost: {launches} launches")
    print(f"[weights] grouped GPBoost with weights, n={N_GROUPED} "
          f"q={Q_GROUPED} float64, {ROUNDS} rounds: first GP fit "
          f"{fit_s:.3f} s, per round {np.mean(secs):.4f} s (min "
          f"{np.min(secs):.4f}, max {np.max(secs):.4f}); host syncs of "
          f"round {ROUNDS + 1}: {syncs}; cov pars "
          f"{gp.get_cov_pars().tolist()}; hist_segment launches {launches}",
          flush=True)
    coords5, y5 = sim_vecchia(N_DENSE_CL, seed=SEED)
    cid5 = np.repeat(np.arange(DENSE_CLUSTERS), N_DENSE_CL // DENSE_CLUSTERS)
    md = gpt.GPModel(gp_coords=coords5, cov_function="exponential",
                     cluster_ids=cid5, device="cuda")
    _, secs, syncs, peak = _timed(torch, lambda: md.fit(y=y5))
    pred = md.predict(gp_coords_pred=coords5[:50] + 0.005,
                      cluster_ids_pred=cid5[:50], predict_var=True)
    _finite("clustered dense variances", pred["var"], (50,), positive=True)
    print(f"[clusters] dense exact GP, n={N_DENSE_CL} in {DENSE_CLUSTERS} "
          f"clusters, float64: fit {secs:.3f} s, "
          f"{md.get_num_optim_iter()} iterations ({md._fit_result.optimizer}"
          f"), {syncs} host syncs, peak {peak:.2f} GiB; cov pars "
          f"{md.get_cov_pars().tolist()}", flush=True)
    return launches


def phase_nesterov(torch, gpt, histogram):
    """w_gpboost1000 with use_nesterov_acc for 10 rounds, then predict;
    card against CPU at n = 2,000 (float64) for Nesterov GPBoost, the
    weighted grouped GPBoost and the clustered dense GP. Returns
    hist_segment's launches of the Nesterov run."""
    _reset_launches(histogram)
    coords, X, y = sim_gpboost(N_FULL)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20, dtype="float32",
                     device="cuda")
    bst = gpt.Booster({**PARAMS, "use_nesterov_acc": True},
                      gpt.Dataset(X, label=y), gp_model=gp, device="cuda")
    refits, refit = [], bst._refit_gp_cov

    def counted_refit():
        refits[-1] += 1
        return refit()

    bst._refit_gp_cov = counted_refit
    secs = []
    for _ in range(ROUNDS):
        refits.append(0)
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = histogram.hist_segment.launches
    Xn, cn = new_points(N_PRED)
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var"):
        _finite(f"nesterov {k}", pred[k], (N_PRED,))
    if launches <= 0:
        raise AssertionError(f"nesterov: {launches} launches")
    print(f"[nesterov] w_gpboost1000 n={N_FULL} float32 with "
          f"use_nesterov_acc, {ROUNDS} rounds: round 1 (with the first GP "
          f"fit) {secs[0]:.3f} s, rounds 2-{ROUNDS} mean "
          f"{np.mean(secs[1:]):.4f} s (min {np.min(secs[1:]):.4f}, max "
          f"{np.max(secs[1:]):.4f}); GP refits per round {refits}; cov pars "
          f"{gp.get_cov_pars().tolist()}; hist_segment launches {launches}",
          flush=True)
    nest = {**PARAMS, "use_nesterov_acc": True}
    runs = {dev: _train(torch, gpt, N_CPU, "float64", dev, params=nest,
                        rounds=ROUNDS_CPU_27_29) for dev in ("cuda", "cpu")}
    (bg, gg, _, tg), (bc, gc, _, tc) = runs["cuda"], runs["cpu"]
    Xn, cn = new_points(200)
    txt = _card_cpu_boosters("nesterov card-vs-cpu", bc, bg, gc, gg, Xn,
                             dict(gp_coords_pred=cn))
    print(f"[nesterov card-vs-cpu] w_gpboost n={N_CPU} float64 "
          f"{ROUNDS_CPU_27_29} rounds: {txt}; train card {tg:.3f} s, cpu "
          f"{tc:.3f} s", flush=True)
    wg = _weights(N_GROUPED_CPU)
    runs = {dev: _train_grouped(torch, gpt, N_GROUPED_CPU, Q_GROUPED_CPU,
                                dev, rounds=ROUNDS_CPU_27_29, weights=wg)
            for dev in ("cuda", "cpu")}
    (bg, gg, _, _), (bc, gc, _, _) = runs["cuda"], runs["cpu"]
    Xn, gn = _grouped_new_rows(Q_GROUPED_CPU, 200)
    txt = _card_cpu_boosters("weighted card-vs-cpu", bc, bg, gc, gg, Xn,
                             dict(group_data_pred=gn))
    print(f"[weights card-vs-cpu] grouped GPBoost with weights n="
          f"{N_GROUPED_CPU} q={Q_GROUPED_CPU} float64 {ROUNDS_CPU_27_29} "
          f"rounds: {txt}", flush=True)
    coords2, y2 = sim_vecchia(N_CPU, seed=SEED)
    cid2 = np.repeat(np.arange(DENSE_CLUSTERS), N_CPU // DENSE_CLUSTERS)
    cp2 = coords2[:100] + 0.005
    fits = {}
    for dev in ("cuda", "cpu"):
        gm = gpt.GPModel(gp_coords=coords2, cov_function="exponential",
                         cluster_ids=cid2, device=dev)
        gm.fit(y=y2)
        fits[dev] = (gm, gm.predict(gp_coords_pred=cp2,
                                    cluster_ids_pred=cid2[:100],
                                    predict_var=True))
    (gg, pg), (gc, pc) = fits["cuda"], fits["cpu"]
    cov_rel = float(np.max(np.abs(gg.get_cov_pars() / gc.get_cov_pars()
                                  - 1.0)))
    perr = max(float(np.max(np.abs(pg[k] - pc[k]))) for k in ("mu", "var"))
    if not (cov_rel < 1e-4 and perr < 1e-4):
        raise AssertionError(f"clustered dense GP card vs CPU: cov pars "
                             f"{cov_rel:.3g}, predictions {perr:.3g}")
    print(f"[clusters card-vs-cpu] dense GP n={N_CPU} in {DENSE_CLUSTERS} "
          f"clusters float64: {gg.get_num_optim_iter()} / "
          f"{gc.get_num_optim_iter()} iterations, cov pars max rel diff "
          f"{cov_rel:.3g}, predictions max |diff| {perr:.3g}", flush=True)
    return launches


# ----------------------------------------------------------------------
# phases 30-32: the model-selection path of plain boosting and GPBoost:
# the LightGBM objectives, bagging and feature_fraction, validation sets
# with early stopping, cv and grid search
OBJECTIVES = ("binary", "poisson", "tweedie", "cross_entropy", "l1",
              "quantile", "huber", "fair", "mape")
SAMPLING = {"bagging_fraction": 0.8, "bagging_freq": 1,
            "feature_fraction": 0.8}
ROUNDS_OBJ, N_OBJ_CPU, ROUNDS_OBJ_CPU = 5, 2_000, 3
N_VALID_BOOST, ROUNDS_VALID, STOP_VALID = 50_000, 150, 10
N_VALID_GROUPED, ROUNDS_VALID_GP, STOP_VALID_GP = 20_000, 60, 5
N_VALID_VECCHIA, ROUNDS_VALID_VECCHIA = 2_000, 20
N_CV, ROUNDS_CV, ROUNDS_GRID, N_CV_CPU, Q_CV_CPU, ROUNDS_CV_CPU = \
    20_000, 40, 10, 1_000, 50, 8
GRID = {"learning_rate": [0.05, 0.1], "min_data_in_leaf": [20, 100]}


def _objective_label(y, objective):
    """Phase 30's labels from one sim_boost draw."""
    if objective == "binary":
        return (y > np.median(y)).astype(float)
    if objective in ("poisson", "tweedie"):
        return np.random.RandomState(5).poisson(
            np.exp(0.5 * (y - y.mean()))).astype(float)
    if objective == "cross_entropy":
        return 1.0 / (1.0 + np.exp(-(y - y.mean())))
    return y


def _objective_runs():
    runs = [(obj, {"objective": obj}) for obj in OBJECTIVES]
    runs[OBJECTIVES.index("quantile")][1]["alpha"] = 0.9
    return runs + [("binary+sampling", {"objective": "binary", **SAMPLING})]


def _growth_records(tree):
    """_split_records in the order the splits were made: split s made the
    nodes 2s + 1 and 2s + 2."""
    return sorted(_split_records(tree), key=lambda r: tree.left[r[0]])


def _equal_prefix(what, ba, bb):
    """(k, note): the number of leading trees with equal splits in two
    boosters (card and CPU), compared in the order the splits were made. At
    the first split that differs, the two sides' best gains (the largest
    over every leaf) must be a float32 near-tie of phase 5's rule
    (relative gap < 1e-5); what follows it is not compared."""
    for k, (ta, tb) in enumerate(zip(ba.trees, bb.trees)):
        ra, rb = _growth_records(ta), _growth_records(tb)
        if [r[:3] for r in ra] == [r[:3] for r in rb]:
            continue
        i = next((j for j, (a, b) in enumerate(zip(ra, rb))
                  if a[:3] != b[:3]), None)
        if i is None:
            raise AssertionError(f"{what}: tree {k} has {len(ra)} splits on "
                                 f"the card, {len(rb)} on the CPU")
        gap = abs(ra[i][3] - rb[i][3]) / max(abs(rb[i][3]), 1e-30)
        if not gap < 1e-5:
            raise AssertionError(f"{what}: tree {k} split {i} differs: card "
                                 f"{ra[i]} cpu {rb[i]}")
        return k, (f"tree {k} split {i} parts at a float32 near-tie "
                   f"(relative gain gap {gap:.3g})")
    return len(ba.trees), "all trees equal"


def phase_objectives(torch, gpt, histogram, ds, y):
    """boosting_n200k_p50's data (the binned Dataset of phases 6-8) with
    each objective, 31 leaves, learning rate 0.1, the serial learner: one
    warm-up round, 5 timed rounds, the host syncs of one more, B1 launches
    and peak memory; then card against CPU at n = 2,000 for 3 rounds.
    Returns hist_segment's launches over the full-width runs."""
    _reset_launches(histogram)
    lines = []
    for name, opts in _objective_runs():
        ds.label = _objective_label(y, opts["objective"])
        torch.cuda.reset_peak_memory_stats()
        l0 = histogram.hist_segment.launches
        bst = gpt.Booster({**BOOST, **opts}, ds, device="cuda")
        bst.update()
        torch.cuda.synchronize()
        secs = []
        for _ in range(ROUNDS_OBJ):
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        _, syncs = _count_syncs(torch, bst.update)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pred = bst.predict(ds.data[:1000])
        _finite(f"objective {name}", pred, (1000,))
        launches = histogram.hist_segment.launches - l0
        if launches <= 0:
            raise AssertionError(f"objective {name}: no hist_segment launch")
        lines.append(f"{name} {np.mean(secs):.4f} s (min {np.min(secs):.4f}"
                     f"), {syncs} syncs, {launches} B1, peak {peak:.2f} GiB")
    launches = histogram.hist_segment.launches
    print(f"[objectives] boosting_n200k_p50 n={N_BOOST} p={P_BOOST}, 31 "
          f"leaves, lr 0.1, serial learner; per objective: mean of "
          f"{ROUNDS_OBJ} rounds after one warm-up, host syncs of round "
          f"{ROUNDS_OBJ + 2}, B1 launches over its "
          f"{ROUNDS_OBJ + 2} rounds, peak memory: " + "; ".join(lines)
          + f"; hist_segment launches in all {launches}", flush=True)
    X2, y2 = sim_boost(N_OBJ_CPU)
    notes = []
    for name, opts in _objective_runs():
        lab = _objective_label(y2, opts["objective"])
        # the gradients at the init score, whatever the trees do after
        gh = [gpt.Booster({**BOOST, **opts}, gpt.Dataset(X2, label=lab),
                          device=dev)._objective_gradients()
              for dev in ("cuda", "cpu")]
        gerr = max(float(torch.max(torch.abs(a.cpu() - b))
                         / torch.max(torch.abs(b))) for a, b in zip(*gh))
        if not gerr < 1e-12:
            raise AssertionError(f"objective {name} card vs CPU: gradients "
                                 f"differ by {gerr:.3g} of their largest")
        bg, bc = (gpt.train({**BOOST, **opts}, gpt.Dataset(X2, label=lab),
                            num_boost_round=ROUNDS_OBJ_CPU, device=dev)
                  for dev in ("cuda", "cpu"))
        if bg.init_score != bc.init_score:
            raise AssertionError(f"objective {name} card vs CPU: init "
                                 f"score {bg.init_score} {bc.init_score}")
        k, note = _equal_prefix(f"objective {name} card vs CPU", bg, bc)
        err = 0.0
        if k:
            err = float(np.max(np.abs(bg.predict(X2, num_iteration=k)
                                      - bc.predict(X2, num_iteration=k))))
        if not err < 1e-6:
            raise AssertionError(f"objective {name} card vs CPU: "
                                 f"predictions differ by {err:.3g}")
        notes.append(f"{name}: grad/hess {gerr:.2g}, {note}, predictions "
                     f"of {k} trees max |diff| {err:.3g}")
    # the leaf renewal of l1, quantile and mape on one input: 31 leaves of
    # n = 200,000 rows, unweighted and weighted
    from gpboost_tpu_torch.boosting.gbdt import _segment_percentiles
    rng = np.random.RandomState(SEED)
    v, key, w = rng.randn(N_BOOST), rng.randint(0, 31, N_BOOST), \
        rng.rand(N_BOOST)
    counts = np.bincount(key, minlength=32)
    for wt in (None, w):
        ren = [_segment_percentiles(
            torch.as_tensor(v, device=dev), torch.as_tensor(key, device=dev),
            counts, None if wt is None else torch.as_tensor(wt, device=dev),
            0.9).cpu() for dev in ("cuda", "cpu")]
        if not torch.equal(*ren):
            raise AssertionError("leaf renewal card vs CPU differs by "
                                 f"{float((ren[0] - ren[1]).abs().max())}")
    print(f"[objectives card-vs-cpu] n={N_OBJ_CPU} p={P_BOOST}, "
          f"{ROUNDS_OBJ_CPU} rounds, init scores equal: " + "; ".join(notes)
          + f"; leaf renewal of {N_BOOST} rows in 31 leaves (alpha 0.9, "
          "unweighted and weighted) equal on both", flush=True)
    return launches


class _RoundClock:
    """Splits a train() run's rounds into the update and the validation:
    Booster.update is timed to its synchronize, and a callback (order -1,
    the first to run after the round's evaluation) takes the time the
    metrics took. A round the loop's early stopping ends has no callback:
    its validation is not counted."""

    def __init__(self, torch, gpt):
        self.torch, self.cls = torch, gpt.Booster
        self.update_s, self.valid_s, self._end = [], [], None

    def __enter__(self):
        self._update = update = self.cls.update
        clock = self

        def timed(bst):
            t0 = time.perf_counter()
            out = update(bst)
            clock.torch.cuda.synchronize()
            clock._end = time.perf_counter()
            clock.update_s.append(clock._end - t0)
            return out

        self.cls.update = timed
        return self

    def __exit__(self, *exc):
        self.cls.update = self._update

    def callback(self):
        def cb(env):
            self.valid_s.append(time.perf_counter() - self._end)
        cb.order = -1
        return cb

    def txt(self):
        v = f"{np.mean(self.valid_s):.4f} s" if self.valid_s else "none"
        return (f"{len(self.update_s)} rounds, {np.mean(self.update_s):.4f} "
                f"s a round without validation (the update), validation "
                f"{v} a round more")


def _steady_syncs(torch, train):
    """Host syncs of a steady round: those of train(4) less train(1), over
    3."""
    return (_count_syncs(torch, lambda: train(4))[1]
            - _count_syncs(torch, lambda: train(1))[1]) / 3.0


def _grouped_valid(q, n_v, seed=SEED + 5):
    """n_v rows from sim_grouped's model with its group effects: levels
    0..q-1 as in training and 50 more never seen (their own effects)."""
    rng = np.random.RandomState(SEED)
    rng.rand(N_GROUPED, P_GROUPED)
    rng.randint(0, q, N_GROUPED)
    b = np.concatenate([0.8 * rng.randn(q),
                        0.8 * np.random.RandomState(seed + 1).randn(50)])
    rng = np.random.RandomState(seed)
    Xv = rng.rand(n_v, P_GROUPED)
    gv = rng.randint(0, q + 50, n_v)
    F = 2 * Xv[:, 0] + 2 * np.sin(8 * Xv[:, 1]) + (Xv[:, 2] > 0.6)
    return Xv, gv, F + b[gv] + 0.3 * rng.randn(n_v)


def _lagaboost_valid(n, q, n_v, seed=SEED_LAGA + 7):
    """n_v rows from sim_lagaboost's model with its group effects."""
    rng = np.random.RandomState(SEED_LAGA)
    rng.randint(0, q, n)
    b = rng.randn(q)
    rng = np.random.RandomState(seed)
    gv = rng.randint(0, q, n_v)
    Xv = rng.rand(n_v, P_LAGA)
    F_true = 2.0 * np.sin(7 * Xv[:, 0]) + Xv[:, 1]
    yv = (rng.rand(n_v) < 1 / (1 + np.exp(-(F_true - 1 + b[gv])))).astype(
        float)
    return Xv, gv, yv


def phase_validation(torch, gpt, histogram, ds, y):
    """Validation and early stopping at full width: (a) binary boosting on
    phase 30's rows, a 50,000-row sim_boost(seed=3) validation set,
    binary_logloss, lr 0.3, up to 150 rounds, early stopping 10; (b)
    phase 10's grouped GPBoost with a 20,000-row validation set through
    gp_valid_data (50 of its levels unseen), l2 and
    test_neg_log_likelihood, up to 60 rounds, early stopping 5; (c)
    w_gpboost1000 (n = 10,000, m = 20, float32) with 2,000 validation
    points through gp_coords_pred, l2, 20 rounds, early stopping 5; (d)
    phase 17's LaGaBoost with a 20,000-row validation set, binary_logloss,
    5 rounds. Returns hist_segment's launches of (a)."""
    from gpboost_tpu_torch.boosting.gbdt import _RunningScore
    from gpboost_tpu_torch.engine import _metric_fn
    med = np.median(y)
    ds.label = (y > med).astype(float)
    Xv, yv = sim_boost(N_VALID_BOOST, seed=3)
    dv = gpt.Dataset(Xv, label=(yv > med).astype(float))
    params = {**BOOST, "objective": "binary", "metric": "binary_logloss",
              "learning_rate": 0.3}
    ev = {}
    _reset_launches(histogram)
    with _RoundClock(torch, gpt) as clock:
        bst = gpt.train(params, ds, num_boost_round=ROUNDS_VALID,
                        valid_sets=[dv], early_stopping_rounds=STOP_VALID,
                        evals_result=ev, callbacks=[clock.callback()],
                        device="cuda")
    launches = histogram.hist_segment.launches
    vals = ev["valid_0"]["binary_logloss"]
    best = bst.best_iteration
    if best != int(np.argmin(vals)) + 1:
        raise AssertionError(f"validation (a): best_iteration {best}, "
                             f"argmin {int(np.argmin(vals)) + 1}")
    again = _metric_fn("binary_logloss")(
        dv.get_label(), bst.predict(Xv, num_iteration=best))
    if not abs(again - vals[best - 1]) <= 1e-12:
        raise AssertionError(f"validation (a): predict(num_iteration="
                             f"{best}) gives {again!r}, recorded "
                             f"{vals[best - 1]!r}")
    if launches <= 0:
        raise AssertionError("validation (a): no hist_segment launch")

    def run(k, valid):
        return gpt.train(params, ds, num_boost_round=k,
                         valid_sets=[dv] if valid else None, device="cuda")

    s_valid, s_plain = _steady_syncs(torch, lambda k: run(k, True)), \
        _steady_syncs(torch, lambda k: run(k, False))
    print(f"[validation] (a) binary boosting n={N_BOOST} p={P_BOOST}, "
          f"validation n={N_VALID_BOOST}, lr 0.3, early stopping "
          f"{STOP_VALID}: {clock.txt()}; best_iteration {best} = argmin + 1, "
          f"best binary_logloss {bst.best_score:.6f}, predict(num_iteration="
          f"{best}) gives it back to {abs(again - vals[best - 1]):.3g}; host "
          f"syncs a steady round {s_valid:.1f} with validation, {s_plain:.1f}"
          f" without; hist_segment launches {launches}", flush=True)

    # (b) grouped GPBoost
    X, group, yg = sim_grouped(N_GROUPED, Q_GROUPED)
    Xgv, ggv, ygv = _grouped_valid(Q_GROUPED, N_VALID_GROUPED)
    parts = []
    for metric in ("l2", "test_neg_log_likelihood"):
        dgv = gpt.Dataset(Xgv, label=ygv)
        dgv.gp_valid_data = {"group_data_pred": ggv}
        gp = gpt.GPModel(group_data=group, device="cuda")
        ev = {}
        with _RoundClock(torch, gpt) as clock:
            bg = gpt.train({**GROUPED, "metric": metric},
                           gpt.Dataset(X, label=yg), gp_model=gp,
                           num_boost_round=ROUNDS_VALID_GP,
                           valid_sets=[dgv], early_stopping_rounds=STOP_VALID_GP,
                           evals_result=ev, callbacks=[clock.callback()],
                           device="cuda")
        v = ev["valid_0"][metric]
        _finite(f"validation (b) {metric}", np.asarray(v), (len(v),))
        if bg.best_iteration != int(np.argmin(v)) + 1:
            raise AssertionError(f"validation (b) {metric}: best_iteration")
        sc = _RunningScore(bg, Xgv)
        _, syncs = _count_syncs(torch, lambda: bg._predict_output(
            sc.advance(bg), predict_var=metric != "l2",
            group_data_pred=ggv))
        parts.append(f"{metric}: {clock.txt()} (the first round's GP fit "
                     f"included), best_iteration {bg.best_iteration}, best "
                     f"{bg.best_score:.6f}, {syncs} host syncs a validation "
                     f"prediction")
    print(f"[validation] (b) grouped GPBoost n={N_GROUPED} q={Q_GROUPED}, "
          f"validation n={N_VALID_GROUPED} (50 levels unseen), early "
          f"stopping {STOP_VALID_GP}: " + "; ".join(parts), flush=True)

    # (c) Vecchia w_gpboost1000
    coords, Xw, yw = sim_gpboost(N_FULL + N_VALID_VECCHIA)
    tr = slice(0, N_FULL)
    va = slice(N_FULL, N_FULL + N_VALID_VECCHIA)
    gp = gpt.GPModel(gp_coords=coords[tr], cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20, dtype="float32",
                     device="cuda")
    search, knn = [], gp._engine._knn_obs

    def timed_knn(*a, **k):
        t0 = time.perf_counter()
        out = knn(*a, **k)
        search.append(time.perf_counter() - t0)
        return out

    gp._engine._knn_obs = timed_knn
    dwv = gpt.Dataset(Xw[va], label=yw[va])
    dwv.gp_valid_data = {"gp_coords_pred": coords[va]}
    ev = {}
    with _RoundClock(torch, gpt) as clock:
        bw = gpt.train({**PARAMS, "metric": "l2"}, gpt.Dataset(
            Xw[tr], label=yw[tr]), gp_model=gp,
            num_boost_round=ROUNDS_VALID_VECCHIA, valid_sets=[dwv],
            early_stopping_rounds=5, evals_result=ev,
            callbacks=[clock.callback()], device="cuda")
    v = ev["valid_0"]["l2"]
    _finite("validation (c)", np.asarray(v), (len(v),))
    print(f"[validation] (c) w_gpboost1000 n={N_FULL} m=20 float32, "
          f"validation {N_VALID_VECCHIA} points (order_obs_first_cond_obs_"
          f"only): {clock.txt()} (the first round's GP fit included); "
          f"neighbour search {np.mean(search):.4f} s a validation "
          f"prediction ({len(search)} searches); best_iteration "
          f"{bw.best_iteration}, l2 {min(v):.6f}", flush=True)

    # (d) binary LaGaBoost
    Xl, gl, yl = sim_lagaboost(N_LAGA, Q_LAGA)
    Xlv, glv, ylv = _lagaboost_valid(N_LAGA, Q_LAGA, N_VALID_GROUPED)
    dlv = gpt.Dataset(Xlv, label=ylv)
    dlv.gp_valid_data = {"group_data_pred": glv}
    gp = gpt.GPModel(group_data=gl, likelihood="bernoulli_logit",
                     device="cuda")
    ev = {}
    with _RoundClock(torch, gpt) as clock:
        bl = gpt.train({**LAGA, "metric": "binary_logloss"},
                       gpt.Dataset(Xl, label=yl), gp_model=gp,
                       num_boost_round=5, valid_sets=[dlv], evals_result=ev,
                       callbacks=[clock.callback()], device="cuda")
    v = ev["valid_0"]["binary_logloss"]
    _finite("validation (d)", np.asarray(v), (5,))
    print(f"[validation] (d) LaGaBoost n={N_LAGA} q={Q_LAGA} "
          f"bernoulli_logit, validation n={N_VALID_GROUPED}: {clock.txt()} "
          f"(the first round's GP fit included); binary_logloss by round "
          f"{[round(x, 6) for x in v]}", flush=True)
    return launches


def _cv_card_cpu(gpt):
    """cv and grid search of grouped GPBoost at n = 1,000 (q = 50) on the
    card and the CPU: mean and stdv curves to 1e-6 over the rounds before
    a float32 near-tie in any fold (phase 5's rule), best_iter and
    best_params equal."""
    X, group, y = sim_grouped(N_CV_CPU, Q_CV_CPU)
    res, grids = {}, {}
    for dev in ("cuda", "cpu"):
        res[dev] = gpt.cv(GROUPED, gpt.Dataset(X, label=y),
                          gp_model=gpt.GPModel(group_data=group, device=dev),
                          num_boost_round=ROUNDS_CV_CPU, nfold=4, seed=3,
                          metrics="l2", early_stopping_rounds=5,
                          return_cvbooster=True, device=dev)
        grids[dev] = gpt.grid_search_tune_parameters(
            GRID, params=GROUPED, train_set=gpt.Dataset(X, label=y),
            gp_model=gpt.GPModel(group_data=group, device=dev), nfold=4,
            num_try_random=2, num_boost_round=5, seed=3, metrics="l2",
            device=dev)
    rg, rc = res["cuda"], res["cpu"]
    k, notes = len(rg["l2-mean"]), []
    for bg, bc in zip(rg["cvbooster"].boosters, rc["cvbooster"].boosters):
        kf, note = _equal_prefix("cv card vs CPU", bg, bc)
        k = min(k, kf)
        notes.append(note)
    err = max(float(np.max(np.abs(np.asarray(rg[c][:k])
                                  - np.asarray(rc[c][:k]))))
              if k else 0.0 for c in ("l2-mean", "l2-stdv"))
    if not err < 1e-6:
        raise AssertionError(f"cv card vs CPU: curves differ by {err:.3g}")
    tie = any("near-tie" in s for s in notes)
    if not tie and rg["best_iter"] != rc["best_iter"]:
        raise AssertionError(f"cv card vs CPU: best_iter {rg['best_iter']} "
                             f"{rc['best_iter']}")
    if grids["cuda"]["best_params"] != grids["cpu"]["best_params"]:
        raise AssertionError(f"grid search card vs CPU: {grids}")
    return (f"folds: {'; '.join(notes)}; curves over {k} rounds max |diff| "
            f"{err:.3g}; best_iter {rg['best_iter']} / {rc['best_iter']}; "
            f"best_params {grids['cuda']['best_params']} on both, best score "
            f"{grids['cuda']['best_score']:.6f} / "
            f"{grids['cpu']['best_score']:.6f}")


def phase_cv(torch, gpt, histogram):
    """cv of grouped GPBoost on phase 10's generator at n = 20,000 (q =
    1,000), 4 folds, l2, up to 40 rounds, early stopping 5; then
    grid_search_tune_parameters over learning_rate x min_data_in_leaf, 1
    random try of ROUNDS_GRID rounds; card against CPU at n = 1,000. Returns
    hist_segment's launches of the cv run."""
    X, group, y = sim_grouped(N_CV, Q_GROUPED)
    _reset_launches(histogram)
    t0 = time.perf_counter()
    res = gpt.cv(GROUPED, gpt.Dataset(X, label=y),
                 gp_model=gpt.GPModel(group_data=group, device="cuda"),
                 num_boost_round=ROUNDS_CV, nfold=4, seed=3, metrics="l2",
                 early_stopping_rounds=5, device="cuda")
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    launches = histogram.hist_segment.launches
    rounds = len(res["l2-mean"])
    _finite("cv l2-mean", np.asarray(res["l2-mean"]), (rounds,))
    if res["best_iter"] != int(np.argmin(res["l2-mean"])) + 1:
        raise AssertionError("cv: best_iter is not argmin + 1")
    if launches <= 0:
        raise AssertionError("cv: no hist_segment launch")
    t0 = time.perf_counter()
    best = gpt.grid_search_tune_parameters(
        GRID, params=GROUPED, train_set=gpt.Dataset(X, label=y),
        gp_model=gpt.GPModel(group_data=group, device="cuda"), nfold=4,
        num_try_random=1, num_boost_round=ROUNDS_GRID, seed=3, metrics="l2",
        device="cuda")
    grid_s = time.perf_counter() - t0
    if best["best_params"] is None or not np.isfinite(best["best_score"]):
        raise AssertionError(f"grid search: {best}")
    print(f"[cv] grouped GPBoost n={N_CV} q={Q_GROUPED}, 4 folds, l2, early "
          f"stopping 5: {rounds} rounds in {cv_s:.3f} s "
          f"({cv_s / (4 * rounds):.4f} s a fold-round, each fold's first GP "
          f"fit included), best_iter {res['best_iter']}, l2 "
          f"{min(res['l2-mean']):.6f}; hist_segment launches {launches}; "
          f"grid search 1 of 4 combinations x {ROUNDS_GRID} rounds "
          f"{grid_s:.3f} s, best {best}", flush=True)
    print(f"[cv card-vs-cpu] n={N_CV_CPU} q={Q_CV_CPU}, {ROUNDS_CV_CPU} "
          f"rounds, grid 2 x 5 rounds: {_cv_card_cpu(gpt)}", flush=True)
    return launches


# ----------------------------------------------------------------------
# phases 33-35: the inducing-point and tapering approximations (FITC,
# FITC-Laplace, tapering, full-scale tapering, full-scale Vecchia)
N_FITC, M_FITC, N_FITC_PRED, N_FITCL, N_FITCL_CPU, M_FITCL_CPU = \
    100_000, 500, 10_000, 50_000, 1_000, 100
ROUNDS_FITCL, ROUNDS_FSA_BOOST = 3, 1
N_FSA, TAPER_FSA, M_FSA, NN_FSVA, MAXIT_FSA = 20_000, 0.02, 100, 30, 10
FITC_FIT = {"optimizer_cov": "lbfgs", "init_cov_pars": [0.5, 1.0, 0.1]}


def _timed_kmeans(gpt, build):
    """(build(), seconds of kmeans++ inside it): the host kmeans++ of
    models/fitc.py, timed by wrapping it while build() runs."""
    from gpboost_tpu_torch.models import fitc
    secs, orig = [], fitc.kmeanspp_indices

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        secs.append(time.perf_counter() - t0)
        return out

    fitc.kmeanspp_indices = timed
    try:
        out = build()
    finally:
        fitc.kmeanspp_indices = orig
    return out, sum(secs)


def _fitc_model(gpt, coords, device, m=M_FITC, **kw):
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       gp_approx="fitc", num_ind_points=m, device=device,
                       **kw)


def phase_fitc(torch, gpt, histogram):
    """FITC at the headline's width (sim_vecchia, n = 100,000, 2-D), 500
    kmeans++ inducing points, float64: kmeans++ and setup seconds, a fit
    (seconds, iterations, optimizer path, host syncs, peak memory), 10,000
    predictions with variances; card against CPU at n = 2,000; then FITC
    GPBoost on w_gpboost1000's data for 10 rounds. Returns hist_segment's
    launches of that run."""
    coords, y = sim_vecchia(N_FITC)
    t0 = time.perf_counter()
    model, km_s = _timed_kmeans(gpt, lambda: _fitc_model(gpt, coords,
                                                         "cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _, fit_s, syncs, peak = _timed(torch, lambda: model.fit(
        y=y, params=FITC_FIT))
    r = model._fit_result
    cov = model.get_cov_pars()
    _finite("fitc cov pars", cov, (3,), positive=True)
    rng = np.random.RandomState(SEED + 33)
    cp = rng.rand(N_FITC_PRED, 2)
    pred, pred_s, pred_syncs, pred_peak = _timed(
        torch, lambda: model.predict(gp_coords_pred=cp, predict_var=True))
    _finite("fitc mu", pred["mu"], (N_FITC_PRED,))
    _finite("fitc var", pred["var"], (N_FITC_PRED,), positive=True)
    print(f"[fitc] sim_vecchia n={N_FITC} m={M_FITC} kmeans++ float64: "
          f"kmeans++ (host) {km_s:.3f} s of setup {setup_s:.3f} s; fit "
          f"({r.optimizer}) {r.num_it} iterations in {fit_s:.3f} s, {syncs} "
          f"host syncs, peak {peak:.2f} GiB, nll "
          f"{r.neg_log_likelihood:.4f}, cov pars {cov.tolist()}; predict "
          f"{N_FITC_PRED} points with variances {pred_s:.3f} s, "
          f"{pred_syncs} host syncs, peak {pred_peak:.2f} GiB", flush=True)
    # card against CPU at n = 2,000: NLL at fixed parameters, a
    # gradient-descent fit, predictions
    c2, y2 = sim_vecchia(N_CPU, seed=SEED)
    cp2 = c2[:200] + 0.004
    out = {}
    for dev in ("cuda", "cpu"):
        m2 = _fitc_model(gpt, c2, dev)
        nll = m2.neg_log_likelihood([0.3, 1.0, 0.2], y2)
        m2.fit(y=y2, params={"optimizer_cov": "gradient_descent",
                             "maxit": 30})
        out[dev] = (nll, m2.get_cov_pars(), m2.get_num_optim_iter(),
                    m2.predict(gp_coords_pred=cp2, predict_var=True))
    (ng, cg, ig, pg), (nc, cc, ic, pc) = out["cuda"], out["cpu"]
    errs = {"nll": abs(ng / nc - 1.0), "cov": _rel_max(cg, cc),
            "mu": _rel_max(pg["mu"], pc["mu"]),
            "var": _rel_max(pg["var"], pc["var"])}
    if max(errs.values()) > 1e-8 or ig != ic:
        raise AssertionError(f"fitc card vs CPU: {errs}, iterations "
                             f"{ig} / {ic}")
    print(f"[fitc card-vs-cpu] n={N_CPU} m={M_FITC} float64: relative "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; {ig} GD iterations on both", flush=True)
    # FITC GPBoost on w_gpboost1000's data
    coords, X, y = sim_gpboost(N_FULL)
    gp = _fitc_model(gpt, coords, "cuda")
    bst = gpt.Booster(dict(PARAMS), gpt.Dataset(X, label=y), gp_model=gp,
                      device="cuda")
    _reset_launches(histogram)
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = histogram.hist_segment.launches
    if len(bst.trees) != ROUNDS or launches <= 0:
        raise AssertionError(f"fitc gpboost: {len(bst.trees)} trees, "
                             f"{launches} launches")
    _, syncs = _count_syncs(torch, bst.update)
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)])
    Xn, cn = new_points(N_PRED)
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var"):
        _finite(f"fitc gpboost {k}", pred[k], (N_PRED,))
    print(f"[fitc gpboost] w_gpboost1000's data n={N_FULL} p={P}, FITC "
          f"m={M_FITC} float64, 31 leaves, {ROUNDS} rounds: round 1 (with "
          f"the first GP fit) {secs[0]:.3f} s, rounds 2-{ROUNDS} mean "
          f"{np.mean(secs[1:]):.4f} s; host syncs of round {ROUNDS + 1} "
          f"{syncs}; device busy over rounds {ROUNDS + 2}-{ROUNDS + 3} "
          f"{_busy_txt(busy, wall, hist_s)}; cov pars "
          f"{gp.get_cov_pars().tolist()}; hist_segment launches {launches}",
          flush=True)
    return launches


def _pois_fitc_data(n, seed=SEED + 34):
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    lat = 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    return coords, rng.poisson(np.exp(0.3 + lat)).astype(float)


def phase_fitc_laplace(torch, gpt, histogram):
    """bernoulli_probit FITC-Laplace on sim_lagab at n = 50,000 with 500
    kmeans++ inducing points (fit seconds, iterations, Newton steps, host
    syncs, peak memory); FITC LaGaBoost for 3 rounds on the same data;
    Poisson card against CPU at n = 1,000. Returns hist_segment's launches
    of the LaGaBoost run."""
    coords, X, y = sim_lagab(N_FITCL)
    kw = dict(likelihood="bernoulli_probit")
    model, km_s = _timed_kmeans(gpt, lambda: _fitc_model(gpt, coords, "cuda",
                                                         **kw))
    model._engine.total_num_mode_it = 0
    _, fit_s, syncs, peak = _timed(torch, lambda: model.fit(
        y=y, params={"maxit": 20}))
    r = model._fit_result
    _finite("fitc-laplace cov pars", r.cov_pars, (2,), positive=True)
    newton = model._engine.total_num_mode_it
    print(f"[fitc-laplace] sim_lagab n={N_FITCL} m={M_FITC} "
          f"bernoulli_probit float64: kmeans++ {km_s:.3f} s; fit "
          f"({r.optimizer}, maxit 20) {r.num_it} iterations in {fit_s:.3f} "
          f"s, {newton} Newton steps, {syncs} host syncs, peak {peak:.2f} "
          f"GiB, nll {r.neg_log_likelihood:.4f}, cov pars "
          f"{r.cov_pars.tolist()}", flush=True)
    gp = _fitc_model(gpt, coords, "cuda", **kw)
    bst = gpt.Booster({**VLB, "num_leaves": 31}, gpt.Dataset(X, label=y),
                      gp_model=gp, device="cuda")
    _reset_launches(histogram)
    secs = []
    for _ in range(ROUNDS_FITCL):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = histogram.hist_segment.launches
    if len(bst.trees) != ROUNDS_FITCL or launches <= 0:
        raise AssertionError(f"fitc lagaboost: {len(bst.trees)} trees, "
                             f"{launches} launches")
    Xn, cn = new_points(N_PRED, seed=SEED + 35)
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    _finite("fitc lagaboost response", pred["response_mean"], (N_PRED,))
    print(f"[fitc lagaboost] sim_lagab n={N_FITCL} p={P_VLB}, FITC-Laplace "
          f"m={M_FITC}, 31 leaves, {ROUNDS_FITCL} rounds: round 1 (with the "
          f"first GP fit) {secs[0]:.3f} s, then "
          + ", ".join(f"{s:.3f}" for s in secs[1:])
          + f" s; cov pars {gp.get_cov_pars().tolist()}; hist_segment "
          f"launches {launches}", flush=True)
    # Poisson card against CPU at n = 1,000
    c2, y2 = _pois_fitc_data(N_FITCL_CPU)
    cp2 = c2[:100] + 0.004
    out = {}
    for dev in ("cuda", "cpu"):
        m2 = _fitc_model(gpt, c2, dev, m=M_FITCL_CPU, likelihood="poisson")
        e = m2._engine
        res = e.laplace_vag_F(np.log([1.0, 5.0]), y2, np.zeros(len(y2)),
                              e.zero_mode())
        steps = e.last_num_mode_it
        pr = m2.predict(y=y2, gp_coords_pred=cp2, cov_pars=[1.0, 0.2],
                        predict_var=True, predict_response=False)
        out[dev] = (res[0], res[1], res[2], steps, pr)
    (ng, gug, gFg, sg, pg), (nc, guc, gFc, sc, pc) = out["cuda"], out["cpu"]
    errs = {"nll": abs(ng / nc - 1.0), "g_u": _rel_max(gug, guc),
            "g_F": _rel_max(gFg, gFc), "mu": _rel_max(pg["mu"], pc["mu"]),
            "var": _rel_max(pg["var"], pc["var"])}
    # the same port code on both devices, as in phases 33 and 35
    if max(errs.values()) > 1e-8 or sg != sc:
        raise AssertionError(f"fitc-laplace card vs CPU: {errs}, Newton "
                             f"steps {sg} / {sc}")
    print(f"[fitc-laplace card-vs-cpu] poisson n={N_FITCL_CPU} "
          f"m={M_FITCL_CPU}: relative "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; {sg} Newton steps on both", flush=True)
    return launches


def _iter_fit(torch, gpt, coords, y, approx, **kw):
    """One iterative fit at n = 20,000: (model, seconds, syncs, peak,
    kmeans++ seconds)."""
    model, km_s = _timed_kmeans(gpt, lambda: gpt.GPModel(
        gp_coords=coords, cov_function="exponential", gp_approx=approx,
        num_ind_points=M_FSA, matrix_inversion_method="iterative",
        device="cuda", **kw))
    eng = model._engine
    eng.cg_stats(reset=True)
    _, secs, syncs, peak = _timed(torch, lambda: model.fit(
        y=y, params={"optimizer_cov": "lbfgs", "maxit": MAXIT_FSA,
                     "init_cov_pars": [0.5, 1.0, 0.1]}))
    return model, secs, syncs, peak, km_s


def phase_taper(torch, gpt):
    """The dense adapters (tapering, full-scale tapering, full-scale
    Vecchia, correlation-based) card against CPU at n = 2,000, GPBoost on
    the full-scale tapering adapter card against CPU, the adapters against
    the exact engine at a taper range of 1e6; the iterative full-scale
    tapering (taper range 0.02, shape 1, 100 inducing points) and
    full-scale Vecchia (100 inducing points, 30 neighbours) fits at
    n = 20,000."""
    c2, y2 = sim_vecchia(N_CPU, seed=SEED)
    cp2 = c2[:100] + 0.004
    pars = [0.3, 1.0, 0.2]
    approxes = (("tapering", dict(cov_fct_taper_range=0.1)),
                ("full_scale_tapering", dict(cov_fct_taper_range=0.1,
                                             num_ind_points=100)),
                ("full_scale_vecchia", dict(num_ind_points=100,
                                            num_neighbors=NN_FSVA)),
                ("full_scale_vecchia_correlation_based",
                 dict(num_ind_points=100, num_neighbors=NN_FSVA)))
    for approx, kw in approxes:
        out = {}
        for dev in ("cuda", "cpu"):
            m = gpt.GPModel(gp_coords=c2, cov_function="exponential",
                            gp_approx=approx, device=dev, **kw)
            t0 = time.perf_counter()
            nll = m.neg_log_likelihood(pars, y2)
            p = m.predict(y=y2, gp_coords_pred=cp2, cov_pars=pars,
                          predict_var=True)
            out[dev] = (nll, p, time.perf_counter() - t0)
        (ng, pg, tg), (nc, pc, tc) = out["cuda"], out["cpu"]
        errs = {"nll": abs(ng / nc - 1.0), "mu": _rel_max(pg["mu"], pc["mu"]),
                "var": _rel_max(pg["var"], pc["var"])}
        if max(errs.values()) > 1e-8:
            raise AssertionError(f"{approx} card vs CPU: {errs}")
        print(f"[taper card-vs-cpu] {approx} n={N_CPU} (dense engine): "
              f"relative " + ", ".join(f"{k} {v:.2e}" for k, v in
                                       errs.items())
              + f"; NLL and predictions card {tg:.3f} s, cpu {tc:.3f} s",
              flush=True)
    # GPBoost on the FSA adapter at the same taper range: the taper and
    # the low rank reach Psi~^-1 in the gradients and the Newton leaves
    c3, X3, y3 = sim_gpboost(N_CPU)
    runs = {}
    for dev in ("cuda", "cpu"):
        gp = gpt.GPModel(gp_coords=c3, cov_function="exponential",
                         gp_approx="full_scale_tapering",
                         cov_fct_taper_range=0.1, num_ind_points=100,
                         device=dev)
        gp.set_optim_params({"optimizer_cov": "gradient_descent",
                             "maxit": 10})
        t0 = time.perf_counter()
        bst = gpt.train({**PARAMS, "leaves_newton_update": True},
                        gpt.Dataset(X3, label=y3),
                        num_boost_round=ROUNDS_FSA_BOOST, gp_model=gp,
                        device=dev)
        runs[dev] = (bst, gp, time.perf_counter() - t0)
    (bg, gg, tg), (bc, gc, tc) = runs["cuda"], runs["cpu"]
    Xn, cn = new_points(200)
    txt = _card_cpu_boosters("fsa gpboost card-vs-cpu", bc, bg, gc, gg, Xn,
                             dict(gp_coords_pred=cn))
    print(f"[fsa gpboost card-vs-cpu] w_gpboost n={N_CPU}, "
          f"full_scale_tapering (taper range 0.1, 100 inducing points) "
          f"float64, Newton leaves, {ROUNDS_FSA_BOOST} rounds: {txt}; train "
          f"card {tg:.3f} s, cpu {tc:.3f} s", flush=True)
    exact = gpt.GPModel(gp_coords=c2, cov_function="exponential",
                        device="cuda").neg_log_likelihood(pars, y2)
    for approx in ("tapering", "full_scale_tapering"):
        nll = gpt.GPModel(gp_coords=c2, cov_function="exponential",
                          gp_approx=approx, cov_fct_taper_range=1e6,
                          num_ind_points=100, device="cuda"
                          ).neg_log_likelihood(pars, y2)
        if abs(nll / exact - 1.0) > 1e-10:
            raise AssertionError(f"{approx} at taper range 1e6: {nll} vs "
                                 f"exact {exact}")
    print(f"[taper] tapering and full_scale_tapering at taper range 1e6 "
          f"equal the exact engine's NLL {exact:.6f} to 1e-10", flush=True)
    coords, y = sim_vecchia(N_FSA, seed=SEED + 35)
    for approx, kw in (("full_scale_tapering",
                        dict(cov_fct_taper_range=TAPER_FSA,
                             cov_fct_taper_shape=1.0)),
                       ("full_scale_vecchia", dict(num_neighbors=NN_FSVA))):
        model, secs, syncs, peak, km_s = _iter_fit(torch, gpt, coords, y,
                                                   approx, **kw)
        eng = model._engine
        st = eng.cg_stats()
        r = model._fit_result
        _finite(f"{approx} cov pars", r.cov_pars, (3,), positive=True)
        extra = f"taper neighbours k={eng.k}, " if hasattr(eng, "k") else ""
        print(f"[{approx} iterative] sim_vecchia n={N_FSA} m_ip={M_FSA} "
              f"{extra}float64, lbfgs maxit {MAXIT_FSA} ({r.optimizer}): "
              f"kmeans++ {km_s:.3f} s; fit {r.num_it} iterations in "
              f"{secs:.3f} s, {syncs} host syncs, peak {peak:.2f} GiB; CG "
              f"{st['solves']} solves, {st['iterations']} iterations, "
              f"{st['at_maxit']} at cg_max_num_it; nll "
              f"{r.neg_log_likelihood:.4f}, cov pars {r.cov_pars.tolist()}",
              flush=True)


# ----------------------------------------------------------------------
# phases 36-38: the combined Vecchia GP + grouped random effects engine
N_CB, SITES_CB, Q_CB, Q_CB2, MAXIT_CB, ROUNDS_CB = \
    50_000, 10_000, 1_000, 200, 5, 1
N_CB_GAUSS, MAXIT_CB_GAUSS, ROUNDS_CB_GAUSS = 20_000, 1, 1
N_CB_SMALL, N_CB_CPU, N_CB_EXACT_CPU = 2_000, 1_000, 500
CB_MODEL = {"cov_function": "exponential", "gp_approx": "vecchia",
            "num_neighbors": M_VL}


def sim_combined(n, n_sites, q, seed=SEED_VLB, q2=None):
    """sim_lagab's latent predictor on n rows at n_sites sites (5 rows a
    site at the default sizes) plus a grouped effect of q levels, probit;
    with q2 a second, crossed grouping from a stream of its own (seed + 1),
    so that the first stream's draws stay those of one grouping. Returns
    (coords, groups (n,) or (n, 2), X, latent, y)."""
    from scipy.stats import norm
    rng = np.random.RandomState(seed)
    sites = rng.rand(n_sites, 2)
    coords = sites[rng.randint(0, n_sites, n)]
    group = rng.randint(0, q, n)
    b = 0.7 * rng.randn(q)
    X = rng.rand(n, P_VLB)
    lat = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 1.0
           + 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
           + b[group])
    if q2 is not None:
        rng2 = np.random.RandomState(seed + 1)
        group2 = rng2.randint(0, q2, n)
        lat = lat + 0.5 * rng2.randn(q2)[group2]
        group = np.c_[group, group2]
    y = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return coords, group, X, lat, y


def _combined_pred_points(q, n_pred, seed=SEED_VLB + 1):
    """n_pred new points in the unit square, half in groups of the
    training data, half in unseen ones (codes q and above)."""
    rng = np.random.RandomState(seed)
    cn, Xn = rng.rand(n_pred, 2), rng.rand(n_pred, P_VLB)
    gn = np.where(np.arange(n_pred) < n_pred // 2,
                  rng.randint(0, q, n_pred), q + rng.randint(0, 50, n_pred))
    return cn, Xn, gn


def phase_combined(torch, gpt, histogram):
    """Binary LaGaBoost over the combined model at full width: sim_combined
    n = 50,000 rows on 10,000 sites, q = 1,000 groups, bernoulli_probit,
    exponential, 20 neighbours, float64, "auto" (the iterative formulation
    above n = 8,000), vadu; 31 leaves, learning rate 0.1, ROUNDS_CB rounds,
    the GP model's first fit capped at MAXIT_CB iterations (phase 25's
    cut). The first
    fit's seconds, iterations, Newton steps, CG iterations and solves at
    cg_max_num_it, host syncs and peak device memory; seconds a round with
    each round's GD refit, the device busy share of one gradient in F,
    hist_segment
    launches (must be positive); then 1,000 predictions with variances,
    half in unseen groups. Returns hist_segment's launches over the 3
    rounds."""
    from gpboost_tpu_torch.models.vecchia_grouped import \
        VecchiaGroupedLaplaceEngine
    coords, group, X, _, y = sim_combined(N_CB, SITES_CB, Q_CB)
    gp = gpt.GPModel(gp_coords=coords, group_data=group,
                     likelihood="bernoulli_probit", dtype="float64",
                     device="cuda", **CB_MODEL)
    eng = gp._engine
    if not (isinstance(eng, VecchiaGroupedLaplaceEngine)
            and eng.matrix_inversion_method == "iterative"
            and eng.cg_preconditioner_type == "vadu"):
        raise AssertionError(f"combined: engine {type(eng).__name__} "
                             f"{eng.matrix_inversion_method}")
    gp.set_optim_params(params={"maxit": MAXIT_CB})
    fit, rec = gp.fit, {}

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.cg_stats(reset=True)
        newton0 = getattr(eng, "total_num_mode_it", 0)
        t = time.perf_counter()
        out, rec["syncs"] = _count_syncs(torch, lambda: fit(*args, **kwargs))
        torch.cuda.synchronize()
        rec["secs"] = time.perf_counter() - t
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["cg"] = eng.cg_stats(reset=True)
        rec["newton"] = eng.total_num_mode_it - newton0
        return out

    _reset_launches(histogram)
    gp.fit = timed_fit
    with _RefitLog(torch) as log:
        t0 = time.perf_counter()
        bst = gpt.Booster(VLB, gpt.Dataset(X, label=y), gp_model=gp,
                          device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        secs = []
        for _ in range(ROUNDS_CB):
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    gp.fit = fit
    secs[0] -= rec["secs"]
    launches = histogram.hist_segment.launches
    cg_rounds = eng.cg_stats(reset=True)
    r = gp._fit_result
    # a round's trace is too long to hold (its CG loops): the busy share
    # of one gradient in F, the work of a round's refit evaluations
    u = eng._u_from_pars(r.cov_pars, r.aux_pars, gp.y)
    busy, wall, _ = _device_busy_s(torch, lambda: eng.vag_F_device(
        u, bst.y, bst.F, r.mode_state, value=False))
    eng.cg_stats(reset=True)
    for line in log.lines():
        print(f"[combined lagaboost] {line}", flush=True)
    cn, Xn, gn = _combined_pred_points(Q_CB, n_pred=N_PRED)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, group_data_pred=gn,
                       predict_var=True)
    pred_s = time.perf_counter() - t0
    cg_pred = eng.cg_stats(reset=True)
    for k in ("response_mean", "response_var", "random_effect_var"):
        _finite(f"combined {k}", pred[k], (N_PRED,), positive=True)
    if not np.all(pred["response_mean"] < 1):
        raise AssertionError("combined: probabilities outside (0, 1)")
    new = gn >= Q_CB
    # an unseen group adds its prior variance to the latent variance
    v_new = float(np.mean(pred["random_effect_var"][new]))
    v_old = float(np.mean(pred["random_effect_var"][~new]))
    cov = gp.get_cov_pars()
    at_maxit = rec["cg"]["at_maxit"] + cg_rounds["at_maxit"] \
        + cg_pred["at_maxit"]
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0) and launches > 0
            and at_maxit == 0 and v_new > v_old):
        raise AssertionError(
            f"combined lagaboost: cov pars {cov}, {launches} hist_segment "
            f"launches, {at_maxit} CG solves at cg_max_num_it, latent "
            f"variance new groups {v_new} vs seen {v_old}")
    print(f"[combined fit] n={N_CB} sites={SITES_CB} (n_u={eng.n_u}) "
          f"q={Q_CB} m={M_VL} bernoulli_probit iterative vadu float64, the "
          f"booster's first GP fit (maxit {MAXIT_CB}): {rec['secs']:.3f} s, "
          f"{gp.get_num_optim_iter()} iterations ({r.optimizer}), "
          f"{rec['newton']} Newton steps, CG {rec['cg']['iterations']} "
          f"iterations in {rec['cg']['solves']} solved columns "
          f"({rec['cg']['at_maxit']} at cg_max_num_it), {rec['syncs']} host "
          f"syncs, peak device memory {rec['peak'] / 2 ** 30:.2f} GiB",
          flush=True)
    print(f"[combined lagaboost] {ROUNDS_CB} rounds, 31 leaves: booster "
          f"with init score {init_s:.3f} s (includes the fit); per round "
          f"{', '.join(f'{x:.3f}' for x in secs)} s; device busy over one "
          f"gradient {_busy_txt(busy, wall)}; CG over the rounds "
          f"{cg_rounds['iterations']} iterations in {cg_rounds['solves']} "
          f"columns ({cg_rounds['at_maxit']} at maxit); cov pars "
          f"{cov.tolist()}; hist_segment launches {launches}", flush=True)
    print(f"[combined predict] {N_PRED} points, {int(new.sum())} in unseen "
          f"groups, with variances: {pred_s:.3f} s, CG "
          f"{cg_pred['iterations']} iterations in {cg_pred['solves']} "
          f"columns; mean latent variance unseen groups {v_new:.4f}, seen "
          f"{v_old:.4f}", flush=True)
    return launches


def _cb_nll(gpt, coords, group, y, pars, device, **kw):
    """(NLL at pars, engine) of a combined model."""
    gp = gpt.GPModel(gp_coords=coords, group_data=group, device=device,
                     **{**CB_MODEL, "likelihood": "bernoulli_probit", **kw})
    return gp.neg_log_likelihood(pars, y), gp._engine


def phase_combined_more(torch, gpt, histogram):
    """GPBoost with a Gaussian response on the combined model at
    n = 20,000 (LaGaBoost over gaussian_latent, iterative; the first fit
    capped at MAXIT_CB_GAUSS iterations, then ROUNDS_CB_GAUSS rounds with
    the parameters held); the
    dense and the iterative
    formulation at n = 2,000 (NLL within 5e-3 relative, the SLQ's bound);
    two crossed groupings (q = 1,000 and 200) at n = 20,000, where ssor
    takes no more CG iterations than vadu and the NLLs agree to 1e-4; the
    exact GP with a grouped effect, gamma, at n = 2,000 on the dense
    Laplace engine. Returns hist_segment's launches over the GPBoost
    rounds."""
    coords, group, X, lat, _ = sim_combined(N_CB_GAUSS, N_CB_GAUSS // 5,
                                            Q_CB)
    yg = lat + 0.5 * np.random.RandomState(SEED_VLB + 3).randn(N_CB_GAUSS)
    gp = gpt.GPModel(gp_coords=coords, group_data=group, device="cuda",
                     **CB_MODEL)
    gp.set_optim_params(params={"maxit": MAXIT_CB_GAUSS})
    eng = gp._engine
    fit, fit_s = gp.fit, []

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    _reset_launches(histogram)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the parameters are held after the first fit: a Gaussian response's
    # GD refit takes ~47 s a round here (142 CG iterations a column);
    # phases 36 and 38 run the combined engine's refit
    bst = gpt.Booster({**VLB, "objective": "regression",
                       "train_gp_model_cov_pars": False},
                      gpt.Dataset(X, label=yg), gp_model=gp, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    secs = []
    for _ in range(ROUNDS_CB_GAUSS):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    gp.fit = fit
    secs[0] -= fit_s[0]
    launches = histogram.hist_segment.launches
    cg = eng.cg_stats(reset=True)
    aux = gp.get_aux_pars()
    if not (gp.likelihood == bst.objective_name == "gaussian_latent"
            and eng.matrix_inversion_method == "iterative"
            and np.all(gp.get_cov_pars() > 0) and aux[0] > 0
            and cg["at_maxit"] == 0 and launches > 0):
        raise AssertionError(f"combined gaussian: {gp.likelihood}, cov "
                             f"{gp.get_cov_pars()}, aux {aux}, CG {cg}, "
                             f"{launches} hist_segment launches")
    print(f"[combined gpboost] n={N_CB_GAUSS} (n_u={eng.n_u}) q={Q_CB} "
          f"Gaussian as gaussian_latent, iterative float64, 31 leaves, "
          f"parameters held after the first fit: "
          f"booster with init score {init_s:.3f} s, first GP fit (maxit "
          f"{MAXIT_CB_GAUSS}) {fit_s[0]:.3f} s, "
          f"{gp.get_num_optim_iter()} iterations; per round "
          f"{', '.join(f'{x:.3f}' for x in secs)} s; {eng.total_num_mode_it} "
          f"Newton steps and CG {cg['iterations']} iterations in "
          f"{cg['solves']} columns over the run; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; cov pars "
          f"{gp.get_cov_pars().tolist()} (names {gp.get_cov_par_names()}), "
          f"error variance {aux[0]:.5f} (simulated 0.25); hist_segment "
          f"launches {launches}", flush=True)
    coords, group, _, _, y = sim_combined(N_CB_SMALL, N_CB_SMALL // 5, 50)
    pars = [0.5, 1.0, 0.1]
    nd, _ = _cb_nll(gpt, coords, group, y, pars, "cuda",
                    matrix_inversion_method="cholesky")
    ni, ei = _cb_nll(gpt, coords, group, y, pars, "cuda",
                     matrix_inversion_method="iterative")
    rel = abs(ni / nd - 1.0)
    if not rel < 5e-3:
        raise AssertionError(f"combined dense {nd} vs iterative {ni}")
    print(f"[combined dense-vs-iterative] n={N_CB_SMALL} q=50: NLL dense "
          f"{nd:.6f}, iterative {ni:.6f} ({ei.num_rand_vec_trace} probes), "
          f"relative {rel:.3g} (bound 5e-3)", flush=True)
    coords, group, _, _, y = sim_combined(N_CB_GAUSS, N_CB_GAUSS // 5, Q_CB,
                                          q2=Q_CB2)
    pars = [0.5, 0.25, 1.0, 0.1]
    out = {}
    for pc in ("vadu", "ssor"):
        gp = gpt.GPModel(gp_coords=coords, group_data=group, device="cuda",
                         likelihood="bernoulli_probit", **CB_MODEL)
        gp.set_optim_params({"cg_preconditioner_type": pc})
        e = gp._engine
        t0 = time.perf_counter()
        nll = gp.neg_log_likelihood(pars, y)
        out[pc] = (nll, e.cg_stats(reset=True), e.last_num_mode_it,
                   time.perf_counter() - t0)
    (nv, cv, sv, tv), (ns, cs, ss, ts) = out["vadu"], out["ssor"]
    if not (abs(ns / nv - 1.0) < 1e-4 and cs["iterations"]
            <= cv["iterations"]):
        raise AssertionError(f"combined crossed: vadu {out['vadu']}, ssor "
                             f"{out['ssor']}")
    print(f"[combined crossed] n={N_CB_GAUSS} q={Q_CB}+{Q_CB2} iterative: "
          f"NLL vadu {nv:.6f}, ssor {ns:.6f} (relative "
          f"{abs(ns / nv - 1.0):.3g}); Newton CG iterations vadu "
          f"{cv['iterations']} ({sv} steps), ssor {cs['iterations']} "
          f"({ss} steps); {tv:.3f} s and {ts:.3f} s", flush=True)
    rng = np.random.RandomState(SEED_VLB + 4)
    c2 = rng.rand(N_CB_SMALL, 2)
    g2 = rng.randint(0, 50, N_CB_SMALL)
    f = np.sin(6 * c2[:, 0]) * np.cos(4 * c2[:, 1]) + 0.5 * rng.randn(50)[g2]
    yg = rng.gamma(2.0, np.exp(f) / 2.0)
    gm = gpt.GPModel(gp_coords=c2, group_data=g2, likelihood="gamma",
                     cov_function="exponential", device="cuda")
    t0 = time.perf_counter()
    gm.fit(y=yg, params={"maxit": 20})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cov = gm.get_cov_pars()
    if not (type(gm._engine).__name__ == "LaplaceDenseEngine"
            and np.all(cov > 0) and np.all(np.isfinite(gm.get_aux_pars()))):
        raise AssertionError(f"exact GP + grouped gamma: {cov}")
    print(f"[exact gp + grouped gamma] n={N_CB_SMALL} q=50 exponential, the "
          f"dense Laplace engine, float64, maxit 20: {secs:.3f} s, "
          f"{gm.get_num_optim_iter()} iterations, cov pars {cov.tolist()}, "
          f"shape {gm.get_aux_pars().tolist()}", flush=True)
    return launches


def _rel_errs(a, b):
    """max relative differences of matching entries of two tuples."""
    return [float(np.max(np.abs(np.asarray(x) - np.asarray(y)))
                  / max(np.max(np.abs(np.asarray(y))), 1e-300))
            for x, y in zip(a, b)]


def phase_combined_card_vs_cpu(torch, gpt):
    """Card against CPU, float64, relative 1e-8: the combined engine's
    dense formulation (gamma, n = N_CB_CPU) and its iterative one (probit,
    n = N_CB_CPU, the same SLQ probes): NLL, g_u, g_F, Newton steps and CG
    iterations equal, predictions with variances (the iterative ones, a
    batched CG at tol 1e-6, to 1e-6 as phase 27's latent CG); the exact
    GP with a
    grouped effect on the dense Laplace engine (probit, n = 500); a
    Gaussian Vecchia Newton fit (n = N_CB_CPU): iterations equal,
    parameters; one combined LaGaBoost round (n = N_CB_CPU) with the
    default GD refit:
    the init score and the first fit (before the tree) to 1e-8, then
    phase 12's rule for the tree, the refitted parameters, the training
    score and the predictions (1e-4)."""
    coords, group, X, lat, y = sim_combined(N_CB_CPU, N_CB_CPU // 5, 20)
    yg = np.random.RandomState(SEED_VLB + 5).gamma(2.0, np.exp(lat) / 2.0)
    F = 0.3 * np.sin(np.arange(N_CB_CPU))
    cn, Xn, gn = _combined_pred_points(20, n_pred=50)
    cases = (("dense gamma", "gamma", "cholesky", yg, [0.5, 1.0, 0.1]),
             ("iterative probit", "bernoulli_probit", "iterative", y,
              [0.5, 1.0, 0.1]))
    for what, lik, mim, yy, pars in cases:
        ev, t0 = {}, time.perf_counter()
        for dev in ("cuda", "cpu"):
            gp = gpt.GPModel(gp_coords=coords, group_data=group, device=dev,
                             **{**CB_MODEL, "likelihood": lik,
                                "matrix_inversion_method": mim})
            eng = gp._engine
            u = eng._u_from_pars(pars, None, yy)
            nll, gu, gF, _ = eng.laplace_vag_F(u, yy, F, eng.zero_mode())
            gp.set_optim_params(params={"init_aux_pars": [2.0]}
                                if lik == "gamma" else {})
            p = gp.predict(y=yy, cov_pars=pars, gp_coords_pred=cn,
                           group_data_pred=gn, predict_var=True,
                           predict_response=False)
            ev[dev] = ((nll, gu, gF, p["mu"], p["var"]),
                       (eng.last_num_mode_it,
                        getattr(eng, "last_num_cg_it", None)))
        errs = _rel_errs(ev["cuda"][0], ev["cpu"][0])
        # the iterative variances come from a batched CG (tol 1e-6), held
        # to 1e-6 as phase 27's latent CG
        lims = [1e-8] * 4 + [1e-6 if mim == "iterative" else 1e-8]
        if not (all(e < lim for e, lim in zip(errs, lims))
                and ev["cuda"][1] == ev["cpu"][1]):
            raise AssertionError(f"combined {what} card vs CPU: {errs}, "
                                 f"(Newton, CG) {ev['cuda'][1]} vs "
                                 f"{ev['cpu'][1]}")
        print(f"[combined card-vs-cpu] {what} n={N_CB_CPU} float64: max "
              f"relative " + ", ".join(f"{k} {v:.3g}" for k, v in zip(
                  ("nll", "g_u", "g_F", "mu", "var"), errs))
              + f"; (Newton steps, CG iterations) {ev['cuda'][1]} both; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    c5, g5 = coords[:N_CB_EXACT_CPU], group[:N_CB_EXACT_CPU]
    ev, t0 = {}, time.perf_counter()
    for dev in ("cuda", "cpu"):
        gp = gpt.GPModel(gp_coords=c5, group_data=g5, device=dev,
                         likelihood="bernoulli_probit",
                         cov_function="exponential")
        eng = gp._engine
        u = eng._u_from_pars([0.5, 1.0, 0.1], None, y[:N_CB_EXACT_CPU])
        nll, gu, gF, _ = eng.laplace_vag_F(u, y[:N_CB_EXACT_CPU],
                                           F[:N_CB_EXACT_CPU],
                                           eng.zero_mode())
        p = gp.predict(y=y[:N_CB_EXACT_CPU], cov_pars=[0.5, 1.0, 0.1],
                       gp_coords_pred=cn, group_data_pred=gn,
                       predict_var=True, predict_response=False)
        ev[dev] = (nll, gu, gF, p["mu"], p["var"])
    errs = _rel_errs(ev["cuda"], ev["cpu"])
    if not max(errs) < 1e-8:
        raise AssertionError(f"exact GP + grouped card vs CPU: {errs}")
    print(f"[exact gp + grouped card-vs-cpu] probit n={N_CB_EXACT_CPU}: max "
          f"relative " + ", ".join(f"{k} {v:.3g}" for k, v in zip(
              ("nll", "g_u", "g_F", "mu", "var"), errs))
          + f"; {time.perf_counter() - t0:.3f} s", flush=True)
    cv, yv = sim_vecchia(N_CB_CPU, seed=SEED)
    fits = {}
    for dev in ("cuda", "cpu"):
        m = gpt.GPModel(gp_coords=cv, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=M_VL, device=dev)
        t0 = time.perf_counter()
        m.fit(y=yv, params={"optimizer_cov": "newton"})
        fits[dev] = (m.get_cov_pars(), m.get_num_optim_iter(),
                     m.get_current_neg_log_likelihood(),
                     time.perf_counter() - t0)
    (cg_, ig, ng, tg), (cc, ic, nc, tc) = fits["cuda"], fits["cpu"]
    rel = float(np.max(np.abs(cg_ / cc - 1.0)))
    if not (rel < 1e-8 and ig == ic and abs(ng / nc - 1.0) < 1e-8):
        raise AssertionError(f"vecchia newton card {cg_} ({ig}) cpu {cc} "
                             f"({ic})")
    print(f"[vecchia newton card-vs-cpu] sim_vecchia n={N_CB_CPU} m={M_VL} "
          f"float64, optimizer_cov newton: {ig} iterations both, cov pars "
          f"max rel diff {rel:.3g}, nll {ng:.8f}; card {tg:.3f} s, cpu "
          f"{tc:.3f} s", flush=True)
    runs, t0 = {}, time.perf_counter()
    for dev in ("cuda", "cpu"):
        gp = gpt.GPModel(gp_coords=coords, group_data=group, device=dev,
                         likelihood="bernoulli_probit", **CB_MODEL)
        gp.set_optim_params(params={"maxit": MAXIT_CB})
        fit, first = gp.fit, []

        def kept_fit(*args, _fit=fit, _gp=gp, _first=first, **kwargs):
            out = _fit(*args, **kwargs)
            _first.append(_gp.get_cov_pars())
            return out

        gp.fit = kept_fit
        bst = gpt.Booster(VLB, gpt.Dataset(X, label=y), gp_model=gp,
                          device=dev)
        bst.update()
        gp.fit = fit
        runs[dev] = (bst, gp, (bst.init_score, first[0]))
    (bg, gg, fg), (bc, gc, fc) = runs["cuda"], runs["cpu"]
    errs = _rel_errs(fg, fc)
    if not max(errs) < 1e-8:
        raise AssertionError(f"combined lagaboost card vs CPU: init score "
                             f"and first fit {errs}")
    txt = _card_cpu_boosters("combined lagaboost card-vs-cpu", bc, bg, gc,
                             gg, Xn[:50], dict(gp_coords_pred=cn,
                                               group_data_pred=gn))
    print(f"[combined lagaboost card-vs-cpu] n={N_CB_CPU} q=20 "
          f"bernoulli_probit cholesky, 1 round with its GD refit: init score "
          f"and first fit's cov pars max rel diff {max(errs):.3g}; {txt}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


# GP random coefficients (spatially varying coefficients): the R suite's
# combined SVC model (tests/test_combined_gp_re_golden.py:661-742) at
# n = 5,000 on the dense engine; adam and sampling
N_SVC, N_SVC_PRED, N_SVC_SAMPLE, N_SVC_DRAWS = 5_000, 1_000, 200, 1_000
N_SVC_LAPLACE, N_SVC_LAPLACE_PRED, ROUNDS_SVC_LAPLACE = 2_000, 500, 3
N_SVC_CPU, N_ADAM_CPU, Q_ADAM_CPU, SEED_SVC = 500, 500, 20, 12


def sim_svc(n, p=P, seed=SEED_SVC):
    """tests/test_combined_gp_re_golden.py's fixture (:36-66) at n rows,
    drawn from a numpy seed: an exponential GP (variance 1, range 0.1)
    with two random-coefficient processes on covariates Z (n, 2), two
    crossed groupings (10 groups of n / 10 rows; n / 10 levels tiled) with
    a random slope x on the first, noise sd 0.2; plus sim_gpboost's
    F(X) over p tree features. The three GP draws share one host Cholesky
    of the n x n kernel."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    sq = np.sum(coords ** 2, 1)
    D = np.sqrt(np.maximum(sq[:, None] + sq[None, :]
                           - 2.0 * coords @ coords.T, 0.0))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-8 * np.eye(n))
    b1, b2, b3 = (C @ rng.randn(n, 3)).T
    Z = rng.rand(n, 2)
    m = 10
    g1, g2 = np.repeat(np.arange(m), n // m), np.tile(np.arange(n // m), m)
    x = np.cos((np.arange(1, n + 1) - n / 2) ** 2 * 5.5 * np.pi / n)
    bg1, bg2, bg3 = rng.randn(m), rng.randn(n // m), rng.randn(m)
    X = rng.rand(n, p)
    f = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    lat = b1 + Z[:, 0] * b2 + Z[:, 1] * b3 + bg1[g1] + bg2[g2] + x * bg3[g1]
    y = f + lat + 0.2 * rng.randn(n)
    # the file's _init10: half the response variance for every variance,
    # a third of the mean distance for every range
    v, md = np.var(y, ddof=1) / 2, float(np.mean(D[np.triu_indices(n, 1)]))
    return dict(coords=coords, Z=Z, groups=np.column_stack([g1, g2]), x=x,
                X=X, y=y, lat=lat - np.mean(lat),
                init=[v, v, v, v, v, md / 3, v, md / 3, v, md / 3])


def _svc_pred_points(n_pred, n, seed=SEED_SVC + 1):
    """New points: coordinates, covariates, the first grouping's levels
    and 10 % unseen levels of the second, slopes and tree features."""
    rng = np.random.RandomState(seed)
    g2 = rng.randint(0, n // 10, n_pred)
    g2[: n_pred // 10] = n + np.arange(n_pred // 10)
    pk = dict(gp_coords_pred=rng.rand(n_pred, 2),
              gp_rand_coef_data_pred=rng.rand(n_pred, 2),
              group_data_pred=np.column_stack([rng.randint(0, 10, n_pred),
                                               g2]),
              group_rand_coef_data_pred=rng.rand(n_pred))
    return pk, rng.rand(n_pred, P)


def _svc_model(gpt, d, device, grouped=True, **kw):
    """The SVC model on d: an exponential GP with d["Z"]'s two
    random-coefficient columns, and with grouped=True the two groupings
    with a slope on the first (10 parameters with the error variance)."""
    extra = dict(group_data=d["groups"], group_rand_coef_data=d["x"],
                 ind_effect_group_rand_coef=1) if grouped else {}
    return gpt.GPModel(gp_coords=d["coords"], gp_rand_coef_data=d["Z"],
                       cov_function="exponential", device=device, **extra,
                       **kw)


def _svc_booster(torch, gpt, d, device):
    """GPBoost on d with the SVC model (w_gpboost1000's trees), its GP fit
    from the file's _init10; the first fit's seconds, host syncs (on the
    card) and iterations go into the returned record."""
    gp = _svc_model(gpt, d, device)
    gp.set_optim_params(params={"init_cov_pars": d["init"]})
    rec, fit = {}, gp.fit

    def counted_fit(*args, **kwargs):
        t0 = time.perf_counter()
        if device == "cuda":
            out, syncs = _count_syncs(torch, lambda: fit(*args, **kwargs))
            torch.cuda.synchronize()
        else:
            out, syncs = fit(*args, **kwargs), None
        rec.setdefault("fit", (time.perf_counter() - t0, syncs,
                               gp.get_num_optim_iter(),
                               gp.get_cov_pars()))
        return out

    gp.fit = counted_fit
    bst = gpt.Booster(dict(PARAMS), gpt.Dataset(d["X"], label=d["y"]),
                      gp_model=gp, device=device)
    return bst, gp, rec


def _mc_check(what, samples, mu, cov):
    """The draws (n_pred, N) against the predicted mean and covariance
    within Monte-Carlo limits: every sample mean within 5 standard errors
    sqrt(cov_ii / N) of mu, every sample covariance entry within 6 of its
    standard errors sqrt((cov_ii cov_jj + cov_ij^2) / (N - 1)) of cov
    (normal approximations; a Gaussian draw passes both with probability
    above 0.999 at 200 points). Returns the largest of each in standard
    errors."""
    N = samples.shape[1]
    d = np.diagonal(cov)
    z_mean = float(np.max(np.abs(samples.mean(1) - mu) / np.sqrt(d / N)))
    se = np.sqrt((np.outer(d, d) + cov ** 2) / (N - 1))
    z_cov = float(np.max(np.abs(np.cov(samples) - cov) / se))
    if not (z_mean < 5.0 and z_cov < 6.0):
        raise AssertionError(f"{what}: sample means {z_mean:.2f}, sample "
                             f"covariances {z_cov:.2f} standard errors "
                             "from the prediction")
    return z_mean, z_cov


def phase_svc(torch, gpt, histogram, kernel_row):
    """Phase 39: SVC GPBoost at full width (sim_svc, n = 5,000, p = 5,
    float64, the dense engine, 10 covariance parameters): hist_segment at
    its shapes (phase 3's checks, bit for bit), 10 rounds, 1,000
    predictions with variances, then 1,000 posterior draws at 200 points
    held to the predicted mean and covariance. Returns hist_segment's
    launches over the rounds."""
    t0 = time.perf_counter()
    d = sim_svc(N_SVC)
    sim_s = time.perf_counter() - t0
    ds = gpt.Dataset(d["X"], label=d["y"])
    ds.construct()
    _segment_at(torch, histogram, ds, kernel_row, SEED_SVC)
    bst, gp, rec = _svc_booster(torch, gpt, d, "cuda")
    _reset_launches(histogram)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = histogram.hist_segment.launches
    if len(bst.trees) != ROUNDS or launches <= 0:
        raise AssertionError(f"svc gpboost: {len(bst.trees)} trees, "
                             f"{launches} launches")
    fit_s, fit_syncs, fit_it, fit_cov = rec["fit"]
    cov = gp.get_cov_pars()
    _finite("svc cov pars", cov, (10,), positive=True)
    busy, wall, hist_s = _device_busy_s(torch, bst.update)
    pk, Xn = _svc_pred_points(N_SVC_PRED, N_SVC)
    pred, pred_s, pred_syncs, _ = _timed(torch, lambda: bst.predict(
        Xn, predict_var=True, **pk))
    for k in ("response_mean", "response_var"):
        _finite(f"svc gpboost {k}", pred[k], (N_SVC_PRED,), k.endswith("var"))
    sk = {k: v[:N_SVC_SAMPLE] for k, v in pk.items()}
    out, samp_s, samp_syncs, _ = _timed(torch, lambda: bst.predict(
        Xn[:N_SVC_SAMPLE], predict_cov_mat=True, sample_posterior=True,
        num_post_samples=N_SVC_DRAWS, seed=SEED_SVC, **sk))
    samples = out["posterior_samples"]
    _finite("svc posterior samples", samples, (N_SVC_SAMPLE, N_SVC_DRAWS))
    z_mean, z_cov = _mc_check("svc posterior samples", samples,
                              out["response_mean"], out["random_effect_cov"])
    print(f"[svc] sim_svc n={N_SVC} p={P} (host simulation {sim_s:.3f} s), "
          f"exponential GP + 2 random-coefficient GPs + 2 crossed groupings "
          f"with a slope, 10 cov pars, dense engine float64, 31 leaves, "
          f"{ROUNDS} rounds: first GP fit {fit_s:.3f} s, {fit_it} "
          f"iterations, {fit_syncs} host syncs, cov pars "
          f"{np.round(fit_cov, 5).tolist()}; round 1 (with the first fit) "
          f"{secs[0]:.3f} s, rounds 2-{ROUNDS} mean {np.mean(secs[1:]):.4f} "
          f"s (each with its GP refit); peak {peak:.2f} GiB; device busy "
          f"over round {ROUNDS + 1} {_busy_txt(busy, wall, hist_s)}; "
          f"hist_segment launches {launches}; final cov pars "
          f"{np.round(cov, 5).tolist()}", flush=True)
    print(f"[svc] predict {N_SVC_PRED} points with variances (gp_rand_coef_"
          f"data_pred, 10 % unseen levels) {pred_s:.3f} s, {pred_syncs} host "
          f"syncs; {N_SVC_DRAWS} posterior draws at {N_SVC_SAMPLE} points "
          f"(covariance, Cholesky and L z on the card) {samp_s:.3f} s, "
          f"{samp_syncs} host syncs: sample means within {z_mean:.2f}, "
          f"sample covariances within {z_cov:.2f} standard errors of the "
          "prediction", flush=True)
    return launches


def _lmm_data(n, q, seed=42):
    """examples/01_grouped_random_effects.py:14-24 (phase 13's LMM)."""
    rng = np.random.RandomState(seed)
    group = rng.randint(0, q, n)
    b = 0.8 * rng.randn(q)
    X = np.column_stack([np.ones(n), rng.rand(n)])
    return group, X, X @ np.array([1.0, 2.0]) + b[group] \
        + 0.5 * rng.randn(n)


def _svc_probit(n, seed=SEED_SVC + 2):
    """A binary probit response on sim_svc's latent field and F(X)."""
    from scipy.stats import norm
    d = sim_svc(n, seed=seed)
    rng = np.random.RandomState(seed + 1)
    lat = d["lat"] + np.sin(3 * d["X"][:, 0]) - 0.5
    d["y"] = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return d


def phase_adam_svc_laplace(torch, gpt, histogram, kernel_row):
    """Phase 40: optimizer_cov="adam" on the LMM of examples/01 (phase
    13's data, n = 100,000, q = 1,000, with X; the Woodbury engine) and on
    bench.py's binary GLMM (phase 15's data; the grouped Laplace engine),
    each beside lbfgs on the same data; then a binary probit SVC model
    (an exponential GP with two random-coefficient processes) on the dense
    Laplace engine at n = 2,000 (hist_segment at its shapes first): the
    fit, 3 LaGaBoost rounds, 500 predictions with 1,000 posterior and
    1,000 prior draws. Returns hist_segment's launches over the rounds."""
    group, X, y = _lmm_data(N_GROUPED, Q_GROUPED)
    g_glmm, y_glmm = sim_glmm(N_GLMM, Q_GLMM)
    cases = ((f"lmm n={N_GROUPED} q={Q_GROUPED} with X",
              dict(group_data=group), dict(y=y, X=X), {}),
             (f"binary glmm n={N_GLMM} q={Q_GLMM} maxit {MAXIT_GLMM}",
              dict(group_data=g_glmm, likelihood="bernoulli_logit"),
              dict(y=y_glmm), {"maxit": MAXIT_GLMM}))
    for what, model_kw, data, params in cases:
        res = {}
        for opt in ("adam", "lbfgs"):
            m = gpt.GPModel(device="cuda", **model_kw)
            _, secs, syncs, _ = _timed(torch, lambda: m.fit(
                **data, params={**params, "optimizer_cov": opt}))
            r = m._fit_result
            res[opt] = (r.num_it, secs, syncs, r.neg_log_likelihood,
                        m.get_cov_pars())
            _finite(f"{what} {opt} cov pars", res[opt][4],
                    res[opt][4].shape, positive=True)
        (ia, sa, ya, na, ca), (il, sl, yl, nl, cl) = res["adam"], \
            res["lbfgs"]
        print(f"[adam] {what}: adam {ia} iterations in {sa:.3f} s ({ya} "
              f"host syncs), nll {na:.6f}, cov pars {ca.tolist()}; lbfgs "
              f"{il} iterations in {sl:.3f} s ({yl} host syncs), nll "
              f"{nl:.6f}; adam - lbfgs nll {na - nl:.3g}", flush=True)
    d = _svc_probit(N_SVC_LAPLACE)
    ds = gpt.Dataset(d["X"], label=d["y"])
    ds.construct()
    _segment_at(torch, histogram, ds, kernel_row, SEED_SVC + 2)
    gp = _svc_model(gpt, d, "cuda", grouped=False,
                    likelihood="bernoulli_probit")
    fit_s = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t0 = time.perf_counter()
        out = fit(*args, **kwargs)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        return out

    gp.fit = timed_fit
    bst = gpt.Booster(dict(VLB), gpt.Dataset(d["X"], label=d["y"]),
                      gp_model=gp, device="cuda")
    _reset_launches(histogram)
    secs = []
    for _ in range(ROUNDS_SVC_LAPLACE):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    gp.fit = fit
    launches = histogram.hist_segment.launches
    if len(bst.trees) != ROUNDS_SVC_LAPLACE or launches <= 0:
        raise AssertionError(f"svc lagaboost: {len(bst.trees)} trees, "
                             f"{launches} launches")
    cov = gp.get_cov_pars()
    _finite("svc probit cov pars", cov, (6,), positive=True)
    pk, Xn = _svc_pred_points(N_SVC_LAPLACE_PRED, N_SVC_LAPLACE)
    pk = {k: pk[k] for k in ("gp_coords_pred", "gp_rand_coef_data_pred")}
    post, post_s, _, _ = _timed(torch, lambda: bst.predict(
        Xn, pred_latent=True, predict_cov_mat=True, sample_posterior=True,
        num_post_samples=N_SVC_DRAWS, seed=SEED_SVC, **pk))
    prior, prior_s, _, _ = _timed(torch, lambda: bst.predict(
        Xn, pred_latent=True, sample_prior=True,
        num_prior_samples=N_SVC_DRAWS, seed=SEED_SVC, **pk))
    F = post["fixed_effect"]
    zp = _mc_check("svc probit posterior draws", post["posterior_samples"],
                   post["random_effect_mean"] + F, post["random_effect_cov"])
    _finite("svc probit prior draws", prior["prior_samples"],
            (N_SVC_LAPLACE_PRED, N_SVC_DRAWS))
    v_prior = float(np.mean(np.var(prior["prior_samples"], 1)))
    v_model = float(np.mean(
        cov[0] + cov[2] * pk["gp_rand_coef_data_pred"][:, 0] ** 2
        + cov[4] * pk["gp_rand_coef_data_pred"][:, 1] ** 2))
    if not abs(v_prior / v_model - 1.0) < 0.05:
        raise AssertionError(f"svc probit prior draws: mean variance "
                             f"{v_prior:.4f}, the model's {v_model:.4f}")
    print(f"[svc lagaboost] binary probit SVC (exponential GP + 2 "
          f"random-coefficient GPs) n={N_SVC_LAPLACE} on the dense Laplace "
          f"engine: fit {fit_s[0]:.3f} s, {gp.get_num_optim_iter()} "
          f"iterations (lbfgs); rounds "
          + ", ".join(f"{x:.3f}" for x in secs)
          + f" s (round 1 with the fit); cov pars {np.round(cov, 5).tolist()}"
          f"; hist_segment launches {launches}; {N_SVC_LAPLACE_PRED} latent "
          f"predictions with {N_SVC_DRAWS} posterior draws {post_s:.3f} s "
          f"(means within {zp[0]:.2f}, covariances within {zp[1]:.2f} "
          f"standard errors), {N_SVC_DRAWS} prior draws {prior_s:.3f} s "
          f"(mean variance {v_prior:.4f}, the model's {v_model:.4f})",
          flush=True)
    return launches


def phase_svc_card_vs_cpu(torch, gpt):
    """Phase 41: card against CPU, float64, at n = 500: SVC GPBoost for 2
    rounds (the init score; trees under phase 5's near-tie rule,
    covariance parameters and predictions after them); both adam fits
    of phase 40 at n = 500 (q = 20): iterations equal, parameters;
    posterior and prior draws at one seed element by element; the probit
    SVC model's Laplace NLL and gradients. Every difference is printed
    before any is held to its limit: relative 1e-8 (1e-10 for the Laplace
    NLL and gradients)."""
    t_all = time.perf_counter()
    d = sim_svc(N_SVC_CPU)
    pk, Xn = _svc_pred_points(50, N_SVC_CPU)
    errs, fails = {}, []
    runs = {}
    for dev in ("cuda", "cpu"):
        bst, gp, rec = _svc_booster(torch, gpt, d, dev)
        for _ in range(2):
            bst.update()
        pred = bst.predict(Xn, predict_var=True, **pk)
        draws = gp.predict(y=d["y"] - bst.F.cpu().numpy(),
                           sample_posterior=True, num_post_samples=100,
                           seed=SEED_SVC, **pk)["posterior_samples"]
        prior = gp.predict(sample_prior=True, num_prior_samples=100,
                           seed=SEED_SVC, **pk)["prior_samples"]
        runs[dev] = (bst, gp, rec["fit"], pred, draws, prior)
    (bg, gg, fg, pg, dg, rg), (bc, gc, fc, pc, dc, rc) = runs["cuda"], \
        runs["cpu"]
    trees = _compare_models("svc gpboost card-vs-cpu", bc, bg)
    errs["init score"] = abs(bg.init_score / bc.init_score - 1.0)
    # the first fit is printed, not held: scipy's L-BFGS-B, run to ftol
    # 1e-16, stops where the two sides' NLLs part in their last bits
    # (16 and 18 iterations, 1.05e-8 apart in the first card run); the
    # refits of the rounds bring both to the same optimum
    first = _rel_errs([fg[3]], [fc[3]])[0]
    errs["cov pars"] = _rel_errs([gg.get_cov_pars()], [gc.get_cov_pars()])[0]
    for k in ("response_mean", "response_var"):
        errs[k] = _rel_errs([pg[k]], [pc[k]])[0]
    errs["posterior draws"] = _rel_errs([dg], [dc])[0]
    errs["prior draws"] = _rel_errs([rg], [rc])[0]
    # adam at n = 500: the LMM with X and the binary GLMM
    group, X, y = _lmm_data(N_ADAM_CPU, Q_ADAM_CPU)
    g_glmm, y_glmm = sim_glmm(N_ADAM_CPU, Q_ADAM_CPU)
    its = {}
    for what, model_kw, data in (
            ("adam lmm", dict(group_data=group), dict(y=y, X=X)),
            ("adam glmm", dict(group_data=g_glmm,
                               likelihood="bernoulli_logit"),
             dict(y=y_glmm))):
        fits = {}
        for dev in ("cuda", "cpu"):
            m = gpt.GPModel(device=dev, **model_kw)
            m.fit(**data, params={"optimizer_cov": "adam"})
            fits[dev] = (m.get_num_optim_iter(), m.get_cov_pars())
        its[what] = (fits["cuda"][0], fits["cpu"][0])
        errs[what + " cov pars"] = _rel_errs([fits["cuda"][1]],
                                             [fits["cpu"][1]])[0]
        if its[what][0] != its[what][1]:
            fails.append(f"{what} iterations {its[what]}")
    # the probit SVC model's Laplace NLL and gradients
    dp = _svc_probit(N_SVC_CPU)
    F = 0.3 * np.sin(np.arange(N_SVC_CPU))
    ev = {}
    for dev in ("cuda", "cpu"):
        m = _svc_model(gpt, dp, dev, grouped=False,
                       likelihood="bernoulli_probit")
        eng = m._engine
        u = eng._u_from_pars([1.0, 0.1, 0.5, 0.15, 0.3, 0.2], None, dp["y"])
        nll, gu, gF, _ = eng.laplace_vag_F(u, dp["y"], F, eng.zero_mode())
        ev[dev] = ((nll, gu, gF), eng.last_num_mode_it)
    for k, e in zip(("laplace nll", "laplace g_u", "laplace g_F"),
                    _rel_errs(ev["cuda"][0], ev["cpu"][0])):
        errs[k] = e
    if ev["cuda"][1] != ev["cpu"][1]:
        fails.append(f"Newton steps {ev['cuda'][1]} / {ev['cpu'][1]}")
    print(f"[svc card-vs-cpu] n={N_SVC_CPU} float64: trees {trees}; first "
          f"fit {fg[2]} / {fc[2]} iterations (card / cpu), cov pars max "
          f"relative {first:.3g}; adam iterations (card, cpu) "
          + ", ".join(f"{k} {v}" for k, v in its.items())
          + f"; Newton steps {ev['cuda'][1]} both; max relative "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; card {fg[0]:.3f} s, cpu {fc[0]:.3f} s for the first fit; "
          f"{time.perf_counter() - t_all:.3f} s", flush=True)
    lims = {k: 1e-10 if k.startswith("laplace") else 1e-8 for k in errs}
    fails += [f"{k} {v:.3g} > {lims[k]:g}" for k, v in errs.items()
              if not v <= lims[k]]
    if fails:
        raise AssertionError("svc card vs CPU: " + "; ".join(fails))


# ======================================================================
# phases 42-44: the likelihood families (likelihoods/families.py, tkc.py)
# with the two-predictor, two-random-effect-set and W+/W- Laplace paths
N_ZI, Q_ZI, P_ZI, SEED_ZI, N_ZI_CPU, Q_ZI_CPU = 100_000, 1_000, 5, 42, 500, 20
ZI_LIK = "zero_inflated_regression_poisson"
N_NEGW, N_HET2, N_VLZ, M_VLZ, N_FITCZ, M_FITCZ = 2_000, 1_000, 5_000, 20, \
    20_000, 200
N_FAM = 1_000


def sim_zi(n, q, p=P_ZI, seed=SEED_ZI):
    """Zero-inflated counts with a grouped effect: the mean block eta =
    0.5 sin(7 x0) + 0.5 x1 - 0.3 + b[group], b ~ N(0, 0.5^2), a structural
    zero with probability sigmoid(zeta), zeta = -1 + 2 x2, else
    Poisson(exp(eta)) (examples/04_non_gaussian.py's design with the
    count likelihood and a zero model of the covariates)."""
    rng = np.random.RandomState(seed)
    group = rng.randint(0, q, n)
    b = 0.5 * rng.randn(q)
    X = rng.rand(n, p)
    eta = 0.5 * np.sin(7 * X[:, 0]) + 0.5 * X[:, 1] - 0.3 + b[group]
    zeta = -1.0 + 2.0 * X[:, 2]
    zero = rng.rand(n) < 1.0 / (1.0 + np.exp(-zeta))
    y = np.where(zero, 0.0, rng.poisson(np.exp(eta))).astype(float)
    return X, group, y


def _zi_booster(torch, gpt, n, q, device, fit_secs=None):
    X, group, y = sim_zi(n, q)
    gp = gpt.GPModel(group_data=group, likelihood=ZI_LIK, device=device)
    if fit_secs is not None:
        fit = gp.fit

        def timed_fit(*args, **kwargs):
            t = time.perf_counter()
            out = fit(*args, **kwargs)
            torch.cuda.synchronize()
            fit_secs.append((time.perf_counter() - t,
                             gp._fit_result.num_it,
                             gp._engine.last_num_mode_it))
            return out

        gp.fit = timed_fit
    bst = gpt.Booster(LAGA, gpt.Dataset(X, label=y), gp_model=gp,
                      device=device)
    return bst, gp, group, y


def phase_zi_lagaboost(torch, gpt, histogram):
    """Two-predictor LaGaBoost at full width (zero_inflated_regression_
    poisson, n = 100,000, q = 1,000, p = 5, 15 leaves) for ROUNDS rounds of
    two trees, then 1,000 predictions, half in unseen groups; a
    one-predictor zero_inflated_negative_binomial GLMM at the same width.
    Returns hist_segment's launches over the ROUNDS rounds."""
    fits = []
    t0 = time.perf_counter()
    bst, gp, group, y = _zi_booster(torch, gpt, N_ZI, Q_ZI, "cuda", fits)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_launches(histogram)
    # ROUNDS rounds, of which the third last counts its host syncs and the
    # last two run under the profiler (every round refits by a full fit,
    # so no round is spent on the instruments alone)
    from collections import Counter
    sites = Counter()
    secs, syncs, busy = [], None, None
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        if r == ROUNDS - 3:
            _, syncs = _count_syncs(torch, bst.update, sites)
        elif r == ROUNDS - 2:
            busy, wall, hist_s = _device_busy_s(
                torch, lambda: [bst.update() for _ in range(2)], cpu=False)
        elif r < ROUNDS - 3:
            bst.update()
        torch.cuda.synchronize()
        if r != ROUNDS - 1:
            secs.append(time.perf_counter() - t0)
        if len(bst.trees) != 2 * (r + 1) and r != ROUNDS - 2:
            raise AssertionError(f"zi lagaboost: round {r + 1} left "
                                 f"{len(bst.trees)} trees")
    launches = histogram.hist_segment.launches
    Xn, gn = _grouped_new_rows(Q_ZI, N_PRED, seed=SEED_ZI + 1)
    Xn = Xn[:, :P_ZI]
    t0 = time.perf_counter()
    pred = bst.predict(Xn, group_data_pred=gn, predict_var=True)
    latent = bst.predict(Xn, group_data_pred=gn, predict_var=True,
                         pred_latent=True)
    pred_s = time.perf_counter() - t0
    half = N_PRED // 2
    if not np.array_equal(latent["random_effect_mean"][half:],
                          np.zeros(N_PRED - half)):
        raise AssertionError("zi lagaboost: unseen groups' latent means are "
                             "not exactly 0")
    _finite("zi lagaboost response mean", pred["response_mean"], (N_PRED,))
    _finite("zi lagaboost response var", pred["response_var"], (N_PRED,))
    if not np.all(pred["response_mean"] >= 0):
        raise AssertionError("zi lagaboost: negative response means")
    cov = gp.get_cov_pars()
    _finite("zi lagaboost cov pars", cov, (1,), positive=True)
    if launches <= 0:
        raise AssertionError(f"zi lagaboost: {launches} hist_segment "
                             "launches")
    f_s, f_it, f_newton = fits[0]
    print(f"[zi lagaboost] n={N_ZI} q={Q_ZI} p={P_ZI} {ZI_LIK} float64, "
          f"15 leaves, {ROUNDS} rounds of 2 trees: booster with init scores "
          f"{init_s:.3f} s ({bst.init_score:.5f}, {bst.init_score2:.5f}), "
          f"of which the first GP fit {f_s:.3f} s ({gp._fit_result.optimizer}"
          f", {f_it} iterations, {f_newton} Newton steps in its last mode "
          f"solve); seconds a round " + ", ".join(f"{s:.3f}" for s in secs)
          + f" (round {ROUNDS - 2} under the sync debug mode, the last "
          f"figure rounds {ROUNDS - 1}-{ROUNDS} together under the "
          f"profiler); host syncs in round {ROUNDS - 2}: {syncs} ("
          + ", ".join(f"{k} x{v}" for k, v in sites.most_common(8))
          + f"); device busy over rounds {ROUNDS - 1}-{ROUNDS}: "
          f"{_busy_txt(busy, wall, hist_s)}; predict {N_PRED} rows twice "
          f"{pred_s:.3f} s; cov pars {cov.tolist()}; hist_segment launches "
          f"over the {ROUNDS} rounds {launches}", flush=True)
    # the one-predictor family with two aux parameters at the same width
    zinb = gpt.GPModel(group_data=group, likelihood="zero_inflated_"
                       "negative_binomial", device="cuda")
    _, s, syncs, peak = _timed(torch, lambda: zinb.fit(
        y=y, params={"maxit": MAXIT_GLMM}))
    r = zinb._fit_result
    _finite("zinb cov pars", r.cov_pars, (1,), positive=True)
    _finite("zinb aux pars", r.aux_pars, (2,), positive=True)
    print(f"[zinb glmm] n={N_ZI} q={Q_ZI} zero_inflated_negative_binomial: "
          f"fit ({r.optimizer}, maxit {MAXIT_GLMM}) {s:.3f} s, {r.num_it} "
          f"iterations, {syncs} host syncs, peak {peak:.2f} GiB; cov pars "
          f"{r.cov_pars.tolist()}, aux (shape, p0) {r.aux_pars.tolist()}",
          flush=True)
    return launches


def _part(torch, what, model, y, **fit_kw):
    """One capped fit on the card: seconds, iterations, syncs, peak."""
    _, s, syncs, peak = _timed(torch, lambda: model.fit(y=y, **fit_kw))
    r = model._fit_result
    _finite(f"{what} cov pars", r.cov_pars, r.cov_pars.shape, positive=True)
    print(f"[families {what}] fit ({r.optimizer}) {s:.3f} s, {r.num_it} "
          f"iterations, {syncs} host syncs, peak {peak:.3f} GiB, nll "
          f"{r.neg_log_likelihood:.4f}, cov pars {r.cov_pars.tolist()}"
          + ("" if r.aux_pars is None
             else f", aux {np.asarray(r.aux_pars).tolist()}"), flush=True)
    return model


def phase_families_engines(torch, gpt):
    """The other engines at reduced size: the dense engine's W+/W- path
    (zero_inflated_poisson, an exponential GP, n = 2,000), two random-effect
    sets (gaussian_heteroscedastic_fixed_and_random, n = 1,000), both
    Vecchia-Laplace engines with two predictors (n = 5,000, m = 20, 2
    iterations each), FITC-Laplace with hurdle_regression_lognormal
    (n = 20,000, 200 inducing points, 2 iterations) and
    asymmetric_laplace_tkc on phase 42's groups."""
    from gpboost_tpu_torch.likelihoods import tkc
    rng = np.random.RandomState(SEED_ZI + 2)
    c = rng.rand(N_NEGW, 2)
    y = np.where(rng.rand(N_NEGW) < 0.3, 0.0,
                 rng.poisson(np.exp(np.sin(5 * c[:, 0]))).astype(float))
    m = gpt.GPModel(gp_coords=c, cov_function="exponential",
                    likelihood="zero_inflated_poisson", device="cuda")
    if not m._engine._w_neg:
        raise AssertionError("zero_inflated_poisson: not on the W+/W- path")
    _part(torch, f"dense W+/W- zero_inflated_poisson n={N_NEGW}", m, y,
          params={"maxit": 10})
    c = rng.rand(N_HET2, 2)
    y = np.sin(4 * c[:, 0]) + np.exp(0.5 * c[:, 1]) * rng.randn(N_HET2)
    m = gpt.GPModel(gp_coords=c, cov_function="exponential",
                    likelihood="gaussian_heteroscedastic_fixed_and_random",
                    device="cuda")
    if m._engine.dim_mode != 2 * N_HET2:
        raise AssertionError("two RE sets: the mode is not 2n")
    _part(torch, f"two RE sets n={N_HET2} (2n mode)", m, y,
          params={"maxit": 10})
    c = rng.rand(N_VLZ, 2)
    zeta = -1.0 + 2.0 * c[:, 1]
    y = np.where(rng.rand(N_VLZ) < 1 / (1 + np.exp(-zeta)), 0.0,
                 rng.poisson(np.exp(np.sin(5 * c[:, 0])))).astype(float)
    X = np.column_stack([np.ones(N_VLZ), c[:, 1]])
    for mim in ("cholesky", "iterative"):
        m = gpt.GPModel(gp_coords=c, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=M_VLZ,
                        likelihood=ZI_LIK, matrix_inversion_method=mim,
                        device="cuda")
        params = {"maxit": 2}
        if mim == "iterative":
            # 10 SLQ probes (the default 50 took 19 s at 2 iterations)
            params["num_rand_vec_trace"] = 10
        _part(torch, f"vecchia {mim} {ZI_LIK} n={N_VLZ} m={M_VLZ}", m, y,
              X=X, params=params)
    c = rng.rand(N_FITCZ, 2)
    zeta = -0.5 + 1.5 * c[:, 1]
    y = np.where(rng.rand(N_FITCZ) < 1 / (1 + np.exp(-zeta)), 0.0,
                 np.exp(np.sin(5 * c[:, 0]) + 0.5 * rng.randn(N_FITCZ)))
    m = gpt.GPModel(gp_coords=c, cov_function="exponential",
                    gp_approx="fitc", num_ind_points=M_FITCZ,
                    likelihood="hurdle_regression_lognormal", device="cuda")
    _part(torch, f"fitc hurdle_regression_lognormal n={N_FITCZ} "
          f"m={M_FITCZ}", m, y, X=np.column_stack([np.ones(N_FITCZ),
                                                   c[:, 1]]),
          params={"maxit": 2})
    _, group, _ = sim_zi(N_ZI, Q_ZI)
    rng = np.random.RandomState(SEED_ZI + 3)
    y = 0.5 * rng.randn(Q_ZI)[group] + rng.standard_t(3, N_ZI)
    m = gpt.GPModel(group_data=group, likelihood="asymmetric_laplace_tkc",
                    likelihood_additional_param=0.5, device="cuda")
    reads = tkc.host_reads
    _part(torch, f"asymmetric_laplace_tkc n={N_ZI} q={Q_ZI}", m, y,
          params={"maxit": 5})
    print(f"[families tkc] the curvature searches made "
          f"{tkc.host_reads - reads} host reads (one per "
          f"{tkc.TERNARY_CHECK} ternary steps)", flush=True)


# per family: internal aux and the response's kind, for phase 44
FAMILY_CASES = {
    "quasi_bernoulli_logit": ([], "frac"),
    "quasi_bernoulli_probit": ([], "frac"),
    "beta_binomial": ([3.5], "frac"),
    "hurdle_gamma": ([1.7, 0.6], "pos0"),
    "hurdle_lognormal": ([0.8, 0.4], "pos0"),
    "zero_inflated_poisson": ([0.7], "count"),
    "zero_inflated_negative_binomial": ([2.3, 0.5], "count"),
    "zero_inflated_negative_binomial_1": ([0.7, 0.3], "count"),
    "gpd": ([0.7], "pos"),
    "egpd_power": ([0.6, 1.8], "pos"),
    "egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5], "pos"),
    "egpd_beta": ([0.6, 1.4], "pos"),
    "egpd_power_beta": ([0.6, 1.4, 2.2], "pos"),
    "hurdle_gpd": ([0.7, 0.8], "pos0"),
    "hurdle_egpd_power": ([0.6, 1.8, 0.5], "pos0"),
    "hurdle_egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5, 0.6], "pos0"),
    "hurdle_egpd_beta": ([0.6, 1.4, 0.7], "pos0"),
    "hurdle_egpd_power_beta": ([0.6, 1.4, 2.2, 0.9], "pos0"),
    "zero_censored_power_transformed_normal": ([1.3, 0.8], "pos0"),
    "zoctn": ([0.8, 1.4, 1.2], "frac01"),
    "zero_one_censored_transformed_beta": ([3.0, 0.1], "frac01"),
    "zero_one_censored_shifted_gamma": ([1.6, 0.2], "frac01"),
    "gaussian_heteroscedastic": ([], "real"),
    "gaussian_heteroscedastic_fixed_and_random": ([], "real"),
    "hurdle_regression_gamma": ([1.7], "pos0"),
    "hurdle_regression_lognormal": ([0.8], "pos0"),
    "hurdle_regression_gpd": ([0.7], "pos0"),
    "hurdle_regression_egpd_power": ([0.6, 1.8], "pos0"),
    "hurdle_regression_egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5], "pos0"),
    "hurdle_regression_egpd_beta": ([0.6, 1.4], "pos0"),
    "hurdle_regression_egpd_power_beta": ([0.6, 1.4, 2.2], "pos0"),
    "zero_inflated_regression_poisson": ([], "count"),
    "zero_inflated_regression_negative_binomial": ([2.3], "count"),
    "zero_inflated_regression_negative_binomial_1": ([0.7], "count"),
}
# d2 through trigamma (polygamma(1, .)), whose CUDA and CPU versions differ
# in the last bits, and through log_ndtr's backward, whose two versions
# differ by up to 6e-10 relative deep in the left tail (on an H100)
FAMILY_LOOSE_D2 = ("beta_binomial", "zero_inflated_negative_binomial_1",
                   "zero_inflated_regression_negative_binomial_1",
                   "zero_one_censored_transformed_beta",
                   "quasi_bernoulli_probit",
                   "zero_censored_power_transformed_normal", "zoctn")


def _family_inputs(n, seed=SEED_ZI + 4):
    rng = np.random.RandomState(seed)
    f = np.linspace(-40.0, 40.0, n)
    zeta = np.clip(rng.permutation(f), -30.0, 30.0)
    frac = rng.rand(n)
    ys = {"frac": frac,
          "count": np.where(rng.rand(n) < 0.35, 0.0,
                            rng.poisson(3, n)).astype(float),
          "pos0": np.where(rng.rand(n) < 0.3, 0.0, rng.gamma(2.0, 1.0, n)),
          "pos": rng.gamma(2.0, 1.0, n) + 0.01,
          "frac01": np.where(rng.rand(n) < 0.2, 0.0,
                             np.where(rng.rand(n) < 0.2, 1.0,
                                      0.05 + 0.9 * frac)),
          "real": 3.0 * rng.randn(n)}
    return f, zeta, ys


def _family_values(torch, lik, y, f, zeta, aux, device):
    """The family's log density and its derivatives (and curvatures) on
    one device, as float64 numpy: {name: array}."""
    T = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=device)
    y, f, zeta, aux = T(y), T(f), T(zeta), T(aux)
    two = lik.num_sets_fe == 2
    out = {}
    if two:
        def s(ff, zz):
            return torch.sum(lik.log_lik2(y, ff, zz, aux))
    else:
        def s(ff, zz):
            return torch.sum(lik.log_lik(y, ff, aux))
    d1f = torch.func.grad(s, 0)
    out["log_lik"] = (lik.log_lik2(y, f, zeta, aux) if two
                      else lik.log_lik(y, f, aux))
    out["d1"] = d1f(f, zeta)
    out["d2"] = torch.func.grad(lambda ff: torch.sum(d1f(ff, zeta)))(f)
    if two:
        d1z = torch.func.grad(s, 1)
        out["d1_zeta"] = d1z(f, zeta)
        out["d2_zeta"] = torch.func.grad(
            lambda zz: torch.sum(d1z(f, zz)))(zeta)
    fm = torch.clamp(f, -8.0, 8.0)
    if hasattr(lik, "fisher_W") and not two:
        out["fisher_W"] = lik.fisher_W(y, fm, aux)
    if hasattr(lik, "fisher_W2"):
        out["fisher_W2"] = lik.fisher_W2(y, fm, zeta, aux)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _family_close(a, b, rtol, atol):
    """(ok, the largest relative difference over the entries above 1e-6
    in magnitude; those below are held by atol)."""
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(a - b))
    big = np.maximum(np.abs(a), np.abs(b))
    ok = same | (err <= rtol * big + atol)
    rel = np.where(same | ~(big > 1e-6), 0.0, err / np.where(big > 0, big,
                                                              1.0))
    return bool(ok.all()), float(np.max(rel)) if rel.size else 0.0


def phase_families_card_vs_cpu(torch, gpt):
    """All 34 families at n = 1,000, card against CPU: log_lik, d1, d2,
    fisher_W / fisher_W2 and, for two predictors, the derivatives in zeta,
    to 1e-12 relative (1e-13 absolute; d2 through trigamma or log_ndtr's
    backward 1e-9, the GPD / EGPD families' d2, which cancels terms of
    size one, 1e-12 absolute); the tkc curvature and its gradient; a
    two-predictor LaGaBoost of 2 rounds at n = 500 (round by round, the
    splits equal but for thresholds moved at equal gains, or up to a near
    tie; each round before any near tie, the first always: parameters to
    1e-8, the training score and predictions outside the moved
    thresholds' intervals to 1e-6);
    test_two_predictor_golden.py's TestHurdleRegressionLognormal and the
    zero_inflated_regression_poisson evaluation of TestZICountRegression at
    that file's tolerances."""
    from gpboost_tpu_torch.likelihoods.base import get_likelihood
    from gpboost_tpu_torch.likelihoods import tkc
    f, zeta, ys = _family_inputs(N_FAM)
    worst, bad = {}, []
    t0 = time.perf_counter()
    for name, (aux, kind) in FAMILY_CASES.items():
        lik = get_likelihood(name)
        ff = np.clip(f, -30.0, 30.0) if name in (
            "beta_binomial", "zero_one_censored_transformed_beta") else f
        vg = _family_values(torch, lik, ys[kind], ff, zeta, aux, "cuda")
        vc = _family_values(torch, lik, ys[kind], ff, zeta, aux, "cpu")
        for k in vg:
            rtol, atol = 1e-12, 1e-13
            if k == "d2" and name in FAMILY_LOOSE_D2:
                rtol = 1e-9
            if k == "d2" and "gpd" in name:
                atol = 1e-12
            ok, rel = _family_close(vg[k], vc[k], rtol, atol)
            worst[k] = max(worst.get(k, 0.0), rel)
            if not ok:
                bad.append(f"{name}.{k} ({rel:.2e})")
    fam_s = time.perf_counter() - t0
    if bad:
        raise AssertionError("families card vs CPU: " + ", ".join(bad))
    print(f"[families card-vs-cpu] {len(FAMILY_CASES)} families at n={N_FAM}"
          f" in {fam_s:.2f} s: largest relative differences (entries above "
          "1e-6) "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    # the tkc curvature and its gradient in the location
    lik = get_likelihood("asymmetric_laplace", 0.3)
    rng = np.random.RandomState(SEED_ZI + 5)
    yt, loc0 = rng.standard_t(3, N_FAM) + 0.5, 0.3 * rng.randn(N_FAM)
    res = {}
    for dev in ("cuda", "cpu"):
        T = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                      device=dev)
        yd, aux, loc = T(yt), T([0.9]), T(loc0).requires_grad_(True)
        reads = tkc.host_reads
        c = tkc.tkc_neg_curvature(
            lambda s_: torch.sum(lik.log_lik(yd, loc + s_, aux), -1),
            N_FAM, loc)
        (g,) = torch.autograd.grad(c, loc)
        res[dev] = (float(c.detach()), g.cpu().numpy(),
                    tkc.host_reads - reads)
    e_c = abs(res["cuda"][0] / res["cpu"][0] - 1.0)
    e_g = _rel_max(res["cuda"][1], res["cpu"][1])
    if e_c > 1e-12 or e_g > 1e-10:
        raise AssertionError(f"tkc card vs CPU: curvature {e_c:.2e}, "
                             f"gradient {e_g:.2e}")
    print(f"[families tkc card-vs-cpu] n={N_FAM}: curvature "
          f"{res['cuda'][0]:.10g}, relative {e_c:.2e}, gradient {e_g:.2e}; "
          f"{res['cuda'][2]} host reads on the card", flush=True)
    # the two-predictor grouped engine at the initial parameters and
    # scores: NLL, g_u and g_F of both blocks, Newton steps
    _, group, y = sim_zi(N_ZI_CPU, Q_ZI_CPU)
    eng_out = {}
    for dev in ("cuda", "cpu"):
        eng = gpt.GPModel(group_data=group, likelihood=ZI_LIK,
                          device=dev)._engine
        F0 = np.r_[np.full(N_ZI_CPU, 0.1), np.full(N_ZI_CPU, -0.4)]
        res = eng.laplace_vag_F(np.log([0.8]), y, F0, eng.zero_mode())
        eng_out[dev] = res[:3] + (eng.last_num_mode_it,)
    (ng, gug, gFg, sg), (nc, guc, gFc, sc) = eng_out["cuda"], eng_out["cpu"]
    e_eng = {"nll": abs(ng / nc - 1.0), "g_u": _rel_max(gug, guc),
             "g_F": _rel_max(gFg, gFc)}
    if max(e_eng.values()) > 1e-10 or sg != sc:
        raise AssertionError(f"zi engine card vs CPU: {e_eng}, Newton "
                             f"steps {sg} / {sc}")
    print(f"[zi engine card-vs-cpu] n={N_ZI_CPU} q={Q_ZI_CPU} {ZI_LIK}: "
          "relative " + ", ".join(f"{k} {v:.2e}" for k, v in e_eng.items())
          + f"; {sg} Newton steps on both", flush=True)
    # two-predictor LaGaBoost, card against CPU
    Xn, gn = _grouped_new_rows(Q_ZI_CPU, 100, seed=SEED_ZI + 6)
    Xn = Xn[:, :P_ZI]
    out = {}
    for dev in ("cuda", "cpu"):
        bst, gp, _, _ = _zi_booster(torch, gpt, N_ZI_CPU, Q_ZI_CPU, dev)
        rounds = []
        for _ in range(2):
            bst.update()
            rounds.append((bst.F.cpu().numpy(), gp.get_cov_pars(),
                           bst.predict(Xn, group_data_pred=gn,
                                       predict_var=True)))
        out[dev] = (bst, rounds)
    (bg, rg), (bc, rc) = out["cuda"], out["cpu"]
    # round by round, each round's two trees (grown from one gradient)
    # split for split. A threshold moved at equal float32 gains cuts the
    # rows alike, so the round's refitted parameters (1e-8), training
    # score and predictions at the new rows outside the moved thresholds'
    # intervals are held; the last two to 1e-6, as the leaf values are
    # float32 histogram sums (the card's fixed point against the CPU's
    # float32 adds: 7.1e-8 apart in the first card run). A near tie of
    # unequal gains splits the rows otherwise, and the rounds from it on
    # are held up to that split only. The first round is held in full
    # (its tie, with this seed, has equal gains).
    errs = {"init scores": _rel_max([bg.init_score, bg.init_score2],
                                    [bc.init_score, bc.init_score2])}
    keep = np.ones(len(Xn), dtype=bool)
    held, notes = 0, []
    for r in range(2):
        moved, near = _threshold_ties("zi lagaboost card-vs-cpu",
                                      bc.trees[2 * r:2 * r + 2],
                                      bg.trees[2 * r:2 * r + 2], 2 * r)
        notes += [f"tree {t[0]} feature {t[2]} threshold moved at equal "
                  "gains" for t in moved]
        if near:
            notes.append(f"round {r + 1}: {near} near tie(s), not held "
                         "further")
            break
        for _, _, feat, t_c, t_g in moved:
            x = Xn[:, feat]
            keep &= ~((x >= min(t_c, t_g)) & (x <= max(t_c, t_g)))
        (Fg, cg, pg), (Fc, cc, pc) = rg[r], rc[r]
        fe = np.r_[keep, keep]       # the fixed effect stacks both blocks
        errs[f"round {r + 1} training score"] = _rel_max(Fg, Fc)
        errs[f"round {r + 1} cov pars"] = _rel_max(cg, cc)
        errs[f"round {r + 1} predictions"] = max(
            [_rel_max(pg["fixed_effect"][fe], pc["fixed_effect"][fe])]
            + [_rel_max(pg[k][keep], pc[k][keep])
               for k in ("response_mean", "response_var")])
        held = r + 1
    lims = {k: 1e-8 if k in ("init scores",) or k.endswith("cov pars")
            else 1e-6 for k in errs}
    if any(v > lims[k] for k, v in errs.items()) or held < 1 \
            or keep.sum() < len(Xn) // 2:
        raise AssertionError(f"zi lagaboost card vs CPU: {errs}, {held} "
                             f"round(s) held, {int(keep.sum())} rows")
    print(f"[zi lagaboost card-vs-cpu] n={N_ZI_CPU} q={Q_ZI_CPU}, 2 rounds "
          f"(4 trees): {'; '.join(notes) or 'every split equal'}; "
          f"{held} round(s) held, predictions at {int(keep.sum())} of "
          f"{len(Xn)} new rows; relative "
          + ", ".join(f"{key} {v:.2e}" for key, v in errs.items()),
          flush=True)
    _two_predictor_goldens(gpt)


def _reg_data():
    """test_two_predictor_golden.py's reg_data (n = 500, m = 50), from
    the R suite's LCG."""
    from gpboost_tpu_torch.utils.datasim import qnorm, sim_rand_unif
    n, m = 500, 50
    group = np.repeat(np.arange(1, m + 1), n // m)
    b1 = qnorm(sim_rand_unif(m, 0.15))
    u1 = sim_rand_unif(n, 0.271)
    u2 = sim_rand_unif(n, 0.55)
    xc = 2 * sim_rand_unif(n, 0.42) - 1
    p0r = 1.0 / (1.0 + np.exp(-(-0.3 + 1.2 * xc)))
    return dict(n=n, m=m, group=group, b1=b1, u1=u1, u2=u2, xc=xc,
                Xr=np.column_stack([np.ones(n), xc]), p0r=p0r)


def _golden_rel(a, b):
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-10)))


def _two_predictor_goldens(gpt):
    """tests/test_two_predictor_golden.py:46-78 (TestHurdleRegression
    Lognormal) and :80-119 (TestZICountRegression.test_eval, Poisson) on
    the card, at that file's tolerances (1e-5 strict, 1e-3 medium); the
    expected numbers copied from there (test_GPModel_zero_inflated_
    hurdle.R:120-175)."""
    from scipy import stats
    d = _reg_data()
    n, m = d["n"], d["m"]
    eta = 0.5 + 0.7 * d["b1"][d["group"] - 1] + 0.6 * d["xc"]
    y = np.where(d["u1"] < d["p0r"], 0.0, np.exp(stats.norm.ppf(
        d["u2"], eta - 0.25, np.sqrt(0.5))))
    lik = "hurdle_regression_lognormal"
    gpm = gpt.GPModel(group_data=d["group"], likelihood=lik, device="cuda")
    nll = gpm.neg_log_likelihood(cov_pars=[0.5], y=y,
                                 fixed_effects=np.zeros(2 * n),
                                 aux_pars=[0.5])
    gp = gpt.GPModel(group_data=d["group"], likelihood=lik,
                     device="cuda").fit(y=y, X=d["Xr"],
                                        params={"maxit": 100})
    est = np.concatenate([gp.get_cov_pars(), gp.get_coef(),
                          gp.get_aux_pars(),
                          [gp.get_current_neg_log_likelihood()]])
    pd = gp.predict(group_data_pred=np.array([1, m + 1]),
                    X_pred=np.array([[1, 0.4], [1, -0.4]]),
                    predict_var=True, predict_response=True)
    errs = {"nll": _golden_rel(nll, 724.385),
            "estimates": _golden_rel(est, [0.305373, 0.352269, 0.734696,
                                           -0.33679, 1.22878, 0.451265,
                                           648.497]),
            "mu": _golden_rel(pd["mu"], [0.518035, 0.85956]),
            "var": _golden_rel(pd["var"], [0.710859, 1.52345])}
    eta = -0.2 + 0.7 * d["b1"][d["group"] - 1] + 0.6 * d["xc"]
    yp = np.where(d["u1"] < d["p0r"], 0.0,
                  stats.poisson.ppf(d["u2"], np.exp(eta)))
    gpm = gpt.GPModel(group_data=d["group"], likelihood=ZI_LIK,
                      device="cuda")
    errs["zip eval"] = _golden_rel(gpm.neg_log_likelihood(
        cov_pars=[0.5], y=yp, fixed_effects=np.zeros(2 * n)), 454.8418)
    lim = {"nll": 1e-5, "estimates": 1e-3, "mu": 1e-3, "var": 1e-3,
           "zip eval": 1e-5}
    if any(errs[k] >= lim[k] for k in errs):
        raise AssertionError(f"two-predictor goldens: {errs}")
    print("[two-predictor goldens] relative to the R suite: "
          + ", ".join(f"{k} {v:.2e} (< {lim[k]:g})" for k, v in errs.items()),
          flush=True)


# the covariance breadth: space-time GPBoost and the general-shape
# Matern at full width, the 14 kernels card against CPU
N_ST, T_ST, M_ST, MAXIT_ST, SEED_ST, N_ST_CPU = 100_000, 20, 20, 20, 14, 2_000
ST_MODEL = {"cov_function": "matern_space_time", "cov_fct_shape": 1.5,
            "gp_approx": "vecchia", "num_neighbors": M_ST,
            "vecchia_ordering": "time"}
N_MES, M_MES, MAXIT_MES, N_MES_CPU = 100_000, 20, 2, 2_000
N_BREADTH = 500
# the JAX test's grid (tests/test_cov_breadth_golden.py:25-50)
BESSEL_X = np.concatenate([np.linspace(1e-3, 1.99, 40),
                           np.linspace(2.0, 40, 40)])
BESSEL_V = [0.01, 0.3, 0.5, 1.0, 1.7, 2.5, 5.8, 10.4]


def sim_space_time(n, p=P, seed=SEED_ST):
    """Space-time data: time binned into 1..20 as the R suite's space-time
    simulation bins its uniforms (tests/test_cov_breadth_golden.py:125-146:
    bin i holds [(i - 1)/20, i/20)), locations uniform on the unit square,
    sim_gpboost's nonlinear F of p covariates, a smooth space-time field
    and noise."""
    rng = np.random.RandomState(seed)
    t = np.floor(rng.rand(n) * T_ST) + 1.0
    s = rng.rand(n, 2)
    X = rng.rand(n, p)
    f = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    b = np.sin(6 * s[:, 0] + 0.3 * t) * np.cos(4 * s[:, 1] - 0.2 * t)
    return np.column_stack([t, s]), X, f + b + 0.3 * rng.randn(n)


def _st_fit_card_cpu(gpt):
    """The space-time GP alone at n = 2,000 on the card and on the CPU,
    maxit 20 (two chunks, a re-determination after each), by gradient
    descent: scipy's L-BFGS-B, which n = 2,000 takes by default, stops on
    relative changes of 1e-16 whose count of iterations moves with the
    last bits of the objective (27 and 29 on the card and on the CPU, to
    parameters within 6.3e-15 of each other), and the device L-BFGS's
    unscaled first step leaves this data's ranges at 1e7-1e42."""
    coords, _, y = sim_space_time(N_ST_CPU, seed=SEED_ST + 1)
    out = {}
    for dev in ("cuda", "cpu"):
        m = gpt.GPModel(gp_coords=coords, device=dev, **ST_MODEL)
        m.fit(y=y, params={"maxit": MAXIT_ST,
                           "optimizer_cov": "gradient_descent"})
        out[dev] = m
    mg, mc = out["cuda"], out["cpu"]
    errs = {"cov pars": _rel_max(mg.get_cov_pars(), mc.get_cov_pars())}
    same_sets = np.array_equal(mg._engine._nn_idx_np, mc._engine._nn_idx_np)
    redet = [c for c, _ in mg.neighbor_redeterminations]
    if errs["cov pars"] > 1e-6 or not same_sets \
            or mg.get_num_optim_iter() != mc.get_num_optim_iter() \
            or redet != [c for c, _ in mc.neighbor_redeterminations] \
            or not redet[0]:
        raise AssertionError(
            f"space-time card vs CPU: {errs}, sets equal {same_sets}, "
            f"iterations {mg.get_num_optim_iter()} / "
            f"{mc.get_num_optim_iter()}, re-determinations {redet} / "
            f"{[c for c, _ in mc.neighbor_redeterminations]}")
    print(f"[space-time card-vs-cpu] n={N_ST_CPU} m={M_ST} gradient "
          f"descent, maxit {MAXIT_ST}: {mg.get_num_optim_iter()} iterations "
          "on both, "
          f"re-determinations {redet} (sets changed) on both, the neighbour "
          f"sets after them equal index for index; relative cov pars "
          f"{errs['cov pars']:.2e}", flush=True)


def phase_space_time(torch, gpt, histogram):
    """Space-time GPBoost at full width: matern_space_time (shape 1.5) on
    [time, s1, s2], Vecchia with 20 neighbours in the time ordering,
    float64, n = 100,000, p = 5, 31 leaves; the first fit capped at 20
    iterations (two chunks, a neighbour re-determination in the
    range-scaled space after each); 10 rounds, 1,000 predictions; then
    card against CPU at n = 2,000. Returns hist_segment's launches over
    the 10 rounds."""
    coords, X, y = sim_space_time(N_ST)
    t0 = time.perf_counter()
    gp = gpt.GPModel(gp_coords=coords, device="cuda", **ST_MODEL)
    search_s = time.perf_counter() - t0
    gp.set_optim_params({"maxit": MAXIT_ST})
    fits, fit = [], gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        torch.cuda.synchronize()
        r, resid = gp._fit_result, kwargs["y"]
        if torch.is_tensor(resid):
            resid = resid.cpu().numpy()
        fits.append((time.perf_counter() - t, np.array(resid),
                     r.cov_pars.copy(), r.num_it, r.optimizer,
                     list(gp.neighbor_redeterminations)))
        return out

    gp.fit = timed_fit
    bst = gpt.Booster(PARAMS, gpt.Dataset(X, label=y), gp_model=gp,
                      device="cuda")
    _reset_launches(histogram)
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = histogram.hist_segment.launches
    fit_s, resid, pars_fit, fit_it, fit_opt, redet = fits[0]
    secs[0] -= fit_s
    from collections import Counter
    sites = Counter()
    _, syncs = _count_syncs(torch, bst.update, sites)
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)], cpu=False)
    rng = np.random.RandomState(SEED_ST + 2)
    Xn = rng.rand(N_PRED, P)
    cn = np.column_stack([np.floor(rng.rand(N_PRED) * T_ST) + 1.0,
                          rng.rand(N_PRED, 2)])
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    cov = gp.get_cov_pars()
    _finite("space-time cov pars", cov, (4,), positive=True)
    _finite("space-time first-fit pars", pars_fit, (4,), positive=True)
    for k in ("response_mean", "response_var"):
        _finite(f"space-time prediction {k}", pred[k], (N_PRED,))
    # the first fit lowered the NLL of its residuals (both on the final
    # neighbour sets)
    nll_init = gp.neg_log_likelihood(gp._default_init_cov_pars(resid), resid)
    nll_fit = gp.neg_log_likelihood(pars_fit, resid)
    if not nll_fit < nll_init:
        raise AssertionError(f"space-time first fit: NLL {nll_fit} not "
                             f"below the initial values' {nll_init}")
    if fit_opt != "device_lbfgs" or launches <= 0 \
            or len(bst.trees) != ROUNDS + 3 or len(redet) > 2:
        raise AssertionError(f"space-time GPBoost: {fit_opt}, {launches} "
                             f"hist_segment launches, {len(bst.trees)} "
                             f"trees, {len(redet)} re-determinations")
    print(f"[space-time] n={N_ST} p={P} [time 1..{T_ST}, s1, s2] "
          f"matern_space_time 1.5, m={M_ST}, time ordering, float64, 31 "
          f"leaves: ordering and first neighbour search {search_s:.3f} s; "
          f"first GP fit {fit_s:.3f} s ({fit_opt}, maxit {MAXIT_ST}, "
          f"{fit_it} iterations; NLL {nll_fit:.4f} below the initial "
          f"values' {nll_init:.4f}); re-determinations " + ", ".join(
              f"{'changed' if c else 'unchanged'} (host search {t:.3f} s)"
              for c, t in redet)
          + "; seconds a round " + ", ".join(f"{v:.3f}" for v in secs)
          + f"; host syncs of round {ROUNDS + 1}: {syncs} ("
          + ", ".join(f"{k} x{v}" for k, v in sites.most_common(6))
          + f"); device busy over rounds {ROUNDS + 2}-{ROUNDS + 3}: "
          f"{_busy_txt(busy, wall, hist_s)}; predict {N_PRED} points "
          f"{pred_s:.3f} s; cov pars {cov.tolist()}; hist_segment launches "
          f"over the {ROUNDS} rounds {launches}", flush=True)
    _st_fit_card_cpu(gpt)
    return launches


def _vag_card_cpu(gpt, kw, coords, y, pars):
    """NLL and gradient wrt the internal parameters of one Gaussian model
    on the card and on the CPU: (relative NLL difference, gradient
    difference over its largest entry)."""
    out = {}
    for dev in ("cuda", "cpu"):
        eng = gpt.GPModel(gp_coords=coords, device=dev, **kw)._engine
        u = np.log(eng.transform_pars(np.asarray(pars, dtype=np.float64)))
        v, g = eng.vag_full(u, eng.prep_y(y))
        out[dev] = (float(v), np.asarray(g))
    (vg, gg), (vc, gc) = out["cuda"], out["cpu"]
    return abs(vg / vc - 1.0), _rel_max(gg, gc)


def phase_matern_shape(torch, gpt):
    """matern_estimate_shape at full width: sim_vecchia(100,000), m = 20,
    float64, on the device L-BFGS with maxit 2; bessel_kv on the card
    against scipy on the JAX test's grid; NLL and gradient card against
    CPU at n = 2,000."""
    from scipy import special
    from gpboost_tpu_torch.ops import special_fns
    coords, y = sim_vecchia(N_MES)
    m = gpt.GPModel(gp_coords=coords, cov_function="matern_estimate_shape",
                    gp_approx="vecchia", num_neighbors=M_MES, device="cuda")
    eng = m._engine
    evals, raw = [], eng.nll_profiled_raw

    def counted(theta, yy):
        evals.append(1)
        return raw(theta, yy)

    eng.nll_profiled_raw = counted
    reads = special_fns.host_reads
    _, fit_s, syncs, peak = _timed(torch, lambda: m.fit(
        y=y, params={"maxit": MAXIT_MES}))
    bessel_reads = special_fns.host_reads - reads
    del eng.nll_profiled_raw
    r = m._fit_result
    _finite("matern_estimate_shape cov pars", r.cov_pars, (4,),
            positive=True)
    if r.optimizer != "device_lbfgs" or not evals:
        raise AssertionError(f"matern_estimate_shape: {r.optimizer}, "
                             f"{len(evals)} evaluations")
    # one NLL-and-gradient evaluation alone, timed with a synchronize
    theta = np.log(eng.transform_pars(r.cov_pars)[1:])
    yd = eng.prep_y(y)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.nll_profiled_vag(theta, yd)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    entries = eng._d_all.numel()
    # the correlation's own work: read the scaled distances and the
    # incoming gradient, write the correlations and their gradient
    bnd_ms, _ = bound(32 * entries, 0)
    print(f"[matern shape] n={N_MES} m={M_MES} sim_vecchia float64 "
          f"matern_estimate_shape: fit ({r.optimizer}, maxit {MAXIT_MES}) "
          f"{fit_s:.3f} s, {r.num_it} iterations, {len(evals)} NLL-and-"
          f"gradient evaluations ({fit_s / len(evals):.3f} s each), "
          f"{syncs} host syncs ({syncs / len(evals):.2f} an evaluation, "
          f"{bessel_reads} of them bessel_kv's reads), peak {peak:.2f} GiB;"
          f" one evaluation alone {min(times):.3f} s (median "
          f"{np.median(times):.3f}) over {entries} kernel entries, their "
          f"byte bound {bnd_ms:.3f} ms; cov pars {r.cov_pars.tolist()}",
          flush=True)
    # bessel_kv on the card against scipy (values and the x-gradient)
    worst = {"values": 0.0, "x-gradient": 0.0}
    for v in BESSEL_V:
        x = torch.as_tensor(BESSEL_X, device="cuda").requires_grad_(True)
        vt = torch.tensor(v, dtype=torch.float64, device="cuda")
        k = special_fns.bessel_kv(vt, x)
        (gx,) = torch.autograd.grad(k.sum(), x)
        kv = special.kv(v, BESSEL_X)
        worst["values"] = max(worst["values"], float(np.max(np.abs(
            k.detach().cpu().numpy() - kv) / kv)))
        kvp = special.kvp(v, BESSEL_X)
        worst["x-gradient"] = max(worst["x-gradient"], float(np.max(np.abs(
            gx.cpu().numpy() - kvp) / np.abs(kvp))))
    if worst["values"] > 1e-10 or worst["x-gradient"] > 1e-10:
        raise AssertionError(f"bessel_kv on the card: {worst}")
    coords2, y2 = sim_vecchia(N_MES_CPU, seed=1)
    e_nll, e_g = _vag_card_cpu(
        gpt, dict(cov_function="matern_estimate_shape", gp_approx="vecchia",
                  num_neighbors=M_MES), coords2, y2, [0.3, 0.8, 0.1, 0.9])
    if e_nll > 1e-9 or e_g > 1e-7:
        raise AssertionError(f"matern_estimate_shape card vs CPU: NLL "
                             f"{e_nll:.2e}, gradient {e_g:.2e}")
    print(f"[matern shape] bessel_kv on the card against scipy on the JAX "
          f"test's grid ({len(BESSEL_V)} orders x {len(BESSEL_X)} "
          f"arguments): values {worst['values']:.2e}, x-gradient against "
          f"kvp {worst['x-gradient']:.2e} relative; card against CPU at "
          f"n={N_MES_CPU}: NLL {e_nll:.2e}, gradient {e_g:.2e}", flush=True)


# (name, model, coordinates' kind, parameters): phase 47's cases
BREADTH_CASES = [
    ("exponential", dict(cov_function="exponential"), "c2", [0.5, 0.3]),
    ("matern 1.0", dict(cov_function="matern", cov_fct_shape=1.0), "c2",
     [0.5, 0.3]),
    ("gaussian", dict(cov_function="gaussian"), "c2", [0.5, 0.3]),
    ("powered_exponential", dict(cov_function="powered_exponential",
                                 cov_fct_shape=1.3), "c2", [0.5, 0.3]),
    ("matern_ard", dict(cov_function="matern_ard"), "c2", [0.5, 0.3, 0.6]),
    ("gaussian_ard", dict(cov_function="gaussian_ard"), "c2",
     [0.5, 0.3, 0.6]),
    ("matern_space_time", dict(cov_function="matern_space_time"), "c3",
     [0.5, 2.0, 0.3]),
    ("wendland", dict(cov_function="wendland", cov_fct_taper_range=0.3),
     "c2", [0.5]),
    ("matern_estimate_shape", dict(cov_function="matern_estimate_shape"),
     "c2", [0.5, 0.3, 0.8]),
    ("matern_ard_estimate_shape", dict(
        cov_function="matern_ard_estimate_shape"), "c2",
     [0.5, 0.3, 0.6, 1.3]),
    ("space_time_gneiting", dict(cov_function="space_time_gneiting"), "c3",
     [1.0, 0.2, 2.0, 0.5, 1.5, 0.5, 2.0]),
    ("hurst", dict(cov_function="hurst"), "c2", [0.5, 0.4]),
    ("hurst_ard", dict(cov_function="hurst_ard"), "c2", [0.5, 0.4, 0.7]),
    ("linear", dict(cov_function="linear"), "c2", [0.5]),
    ("ar1_mf_exponential", dict(cov_function="ar1_mf_exponential"), "cf",
     [0.5, 0.3, 0.2, 0.4, -0.4]),
    ("vecchia hurst", dict(cov_function="hurst", gp_approx="vecchia"), "c2",
     [0.5, 0.4]),
    ("vecchia linear", dict(cov_function="linear", gp_approx="vecchia"),
     "c2", [0.5]),
    ("vecchia_euclidean ar1_mf_exponential", dict(
        cov_function="ar1_mf_exponential", gp_approx="vecchia_euclidean"),
     "cf", [0.5, 0.3, 0.2, 0.4, -0.4]),
    ("tapering gaussian_ard", dict(cov_function="gaussian_ard",
                                   gp_approx="tapering",
                                   cov_fct_taper_range=0.3), "c2",
     [0.5, 0.3, 0.6]),
    ("fitc matern_ard", dict(cov_function="matern_ard", gp_approx="fitc",
                             num_ind_points=50), "c2", [0.5, 0.3, 0.6]),
]
BREADTH_BESSEL = ("matern 1.0", "matern_estimate_shape",
                  "matern_ard_estimate_shape", "space_time_gneiting")


def _breadth_coords(n, seed):
    rng = np.random.RandomState(seed)
    c2 = rng.rand(n, 2)
    return {"c2": c2,
            "c3": np.column_stack([np.floor(rng.rand(n) * T_ST) + 1.0,
                                   rng.rand(n, 2)]),
            "cf": np.column_stack([rng.rand(n),
                                   (rng.rand(n) < 0.4).astype(float)])}, \
        np.sin(4 * c2[:, 0]) + 0.3 * rng.randn(n)


def phase_breadth_card_vs_cpu(torch, gpt):
    """The breadth card against CPU at n = 500, float64: each of the 14
    kernels and ar1_mf_exponential on the dense engine, hurst, linear and
    ar1_mf_exponential (vecchia_euclidean) on the Vecchia engine,
    gaussian_ard on the tapering adapter and matern_ard on FITC: NLL and
    gradient (relative 1e-10 and 1e-8; the Bessel kernels 1e-9 and 1e-7),
    the last two's predictions (1e-8); a two-iteration Bernoulli fit with
    ar1_mf_exponential; TestVecchiaAnisotropic's dense-equals-Vecchia
    golden on the card."""
    coords, y = _breadth_coords(N_BREADTH, SEED_ST + 5)
    worst, bad = {}, []
    t0 = time.perf_counter()
    for name, kw, ck, pars in BREADTH_CASES:
        kw = dict(kw, num_neighbors=20) if "vecchia" in kw.get(
            "gp_approx", "") else kw
        e_nll, e_g = _vag_card_cpu(gpt, kw, coords[ck], y, [0.2] + pars)
        bessel = name in BREADTH_BESSEL
        lim = (1e-9, 1e-7) if bessel else (1e-10, 1e-8)
        worst[name] = (e_nll, e_g)
        if e_nll > lim[0] or e_g > lim[1]:
            bad.append(f"{name} (NLL {e_nll:.2e}, gradient {e_g:.2e})")
    cp = _breadth_coords(50, SEED_ST + 6)[0]["c2"]
    for name, kw, ck, pars in BREADTH_CASES[-2:]:
        p = {}
        for dev in ("cuda", "cpu"):
            p[dev] = gpt.GPModel(gp_coords=coords[ck], device=dev,
                                 **kw).predict(y=y, gp_coords_pred=cp,
                                               cov_pars=[0.2] + pars,
                                               predict_var=True)
        e = max(_rel_max(p["cuda"][k], p["cpu"][k]) for k in ("mu", "var"))
        worst[name + " predictions"] = (e, 0.0)
        if e > 1e-8:
            bad.append(f"{name} predictions {e:.2e}")
    yb = (y > 0).astype(float)
    fits = {}
    for dev in ("cuda", "cpu"):
        m = gpt.GPModel(gp_coords=coords["cf"], likelihood="bernoulli_probit",
                        cov_function="ar1_mf_exponential", device=dev)
        m.fit(y=yb, params={"maxit": 2})
        fits[dev] = (m.get_cov_pars(), m.get_num_optim_iter())
    e_fit = _rel_max(fits["cuda"][0], fits["cpu"][0])
    if e_fit > 1e-6 or fits["cuda"][1] != fits["cpu"][1] \
            or not np.all(np.isfinite(fits["cuda"][0])):
        bad.append(f"ar1 bernoulli fit {e_fit:.2e}, iterations "
                   f"{fits['cuda'][1]} / {fits['cpu'][1]}")
    if bad:
        raise AssertionError("breadth card vs CPU: " + "; ".join(bad))
    print(f"[breadth card-vs-cpu] n={N_BREADTH} float64, "
          f"{len(BREADTH_CASES)} models in {time.perf_counter() - t0:.2f} s;"
          " relative NLL, gradient: " + ", ".join(
              f"{k} {a:.1e}/{b:.1e}" for k, (a, b) in worst.items())
          + f"; ar1_mf_exponential bernoulli_probit fit (maxit 2): "
          f"{fits['cuda'][1]} iterations on both, cov pars {e_fit:.2e}",
          flush=True)
    _vecchia_aniso_golden(gpt)


def _vecchia_aniso_golden(gpt):
    """tests/test_vecchia_golden.py TestVecchiaAnisotropic::
    test_ard_full_neighbors_equals_dense on the card: matern_ard Vecchia
    with m = n - 1 gives the dense NLL and predictions at the file's
    strict tolerance (1e-5), on the R suite's GP data (tests/conftest.py
    gp_sim_data)."""
    from gpboost_tpu_torch.utils.datasim import qnorm, r_matrix, sim_rand_unif
    n = 100
    coords = r_matrix(sim_rand_unif(n * 2, init_c=0.1), ncol=2)
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + np.eye(n) * 1e-20)
    y = C @ qnorm(sim_rand_unif(n, init_c=0.8)) \
        + qnorm(sim_rand_unif(n, init_c=0.1)) / 5.0
    cov_pars = [0.1, 1.3, 0.2, 0.4]
    kw = dict(gp_coords=coords, cov_function="matern_ard", cov_fct_shape=1.5,
              device="cuda")
    dense = gpt.GPModel(**kw)
    mv = gpt.GPModel(gp_approx="vecchia", num_neighbors=99,
                     vecchia_ordering="none", **kw)
    e_nll = abs(mv.neg_log_likelihood(cov_pars, y)
                - dense.neg_log_likelihood(cov_pars, y))
    ct = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
    exact = dense.predict(y=y, gp_coords_pred=ct, cov_pars=cov_pars,
                          predict_var=True, predict_response=True)
    mv.set_prediction_data(vecchia_pred_type="order_obs_first_cond_obs_only",
                           num_neighbors_pred=100)
    pred = mv.predict(y=y, gp_coords_pred=ct, cov_pars=cov_pars,
                      predict_var=True, predict_response=True)
    e_mu = float(np.max(np.abs(pred["mu"] - exact["mu"])))
    e_var = float(np.max(np.abs(pred["var"] - exact["var"])))
    if max(e_nll, e_mu, e_var) >= 1e-5:
        raise AssertionError(f"aniso golden on the card: NLL {e_nll:.2e}, "
                             f"mu {e_mu:.2e}, var {e_var:.2e}")
    print(f"[aniso golden] TestVecchiaAnisotropic dense == Vecchia (m = 99) "
          f"on the card: |NLL| {e_nll:.2e}, mu {e_mu:.2e}, var {e_var:.2e} "
          "(< 1e-5)", flush=True)


# phases 48-50: the tree learner's data and split breadth on mixed tabular
# data at boosting_n200k_p50's shape
N_TAB, SEED_TAB, N_TAB_PRED, N_TAB_CPU = 200_000, 16, 10_000, 2_000
TAB_CARDS = (5, 10, 20, 40, 80, 120, 200, 300, 400, 500)
TAB_CAT, TAB_NAN, TAB_DENSE, TAB_SPARSE = 10, 10, 10, 20
ROUNDS_TAB, ROUNDS_TAB_255, ROUNDS_TAB_OPT, ROUNDS_TAB_CPU = 20, 10, 10, 3
N_TAB_GP, Q_TAB_GP = 100_000, 1_000
TAB = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 31,
       "verbose": 0}
# learner features: the 30 kept columns in order, then the bundle (30)
TAB_MONO = [0] * 20 + [1, 1, -1] + [0] * 7
TAB_OPTS = {"path_smooth": 10.0,
            "interaction_constraints": [list(range(0, 10)) + [20, 21, 30],
                                        list(range(10, 30))],
            "cegb_tradeoff": 1.0, "cegb_penalty_split": 1e-7,
            "cegb_penalty_feature_coupled": [0.02] * 10 + [0.0] * 40,
            "cegb_penalty_feature_lazy": [0.0] * 20 + [1e-6] * 30}
TAB_FORCED = {"feature": 20, "threshold": 0.5,
              "left": {"feature": 21, "threshold": 0.3},
              "right": {"feature": 10, "threshold": 0.0}}
# the R^2 on 10,000 training rows each model must pass (10-20 rounds at
# learning rate 0.1 reach 0.37-0.52; extra trees with forced splits 0.19)
TAB_MIN_R2 = 0.1
# B1 at an EFB bundle of 20 features of 255 bins and the all-default bin
WIDE_BINS = 1 + 20 * 256


def sim_tabular(n, seed=SEED_TAB):
    """Mixed tabular data: TAB_CAT categorical columns (TAB_CARDS levels,
    Zipf(1.1) frequencies), TAB_NAN numeric columns with 20 % NaN,
    TAB_DENSE dense numeric columns (y rises with the first two and falls
    with the third), then TAB_SPARSE sparse columns, ~95 % zeros each and
    at most one non-zero of them a row (one EFB bundle of ~5,100 bins; y
    moves with which of them is set and with its value). A missing value
    moves y by its column's own shift."""
    rng = np.random.RandomState(seed)
    cols, F = [], np.zeros(n)
    for k in TAB_CARDS:
        w = 1.0 / np.arange(1, k + 1) ** 1.1
        c = rng.choice(k, n, p=w / w.sum())
        cols.append(c.astype(float))
        F += 0.5 * rng.randn(k)[c]
    for j in range(TAB_NAN):
        x = rng.randn(n)
        miss = rng.rand(n) < 0.2
        F += np.where(miss, 0.8 * (-1) ** j, 0.4 * np.tanh(x))
        x[miss] = np.nan
        cols.append(x)
    D = rng.rand(n, TAB_DENSE)
    F += 2 * D[:, 0] + D[:, 1] - 1.5 * D[:, 2] + np.sin(4 * D[:, 3])
    cols.extend(D.T)
    # distinct frequencies (5.9 % down to 4.1 %): EFB orders a bundle's
    # members by their counts, so the bundle's bins follow the columns
    pw = 1.0 - 0.015 * np.arange(TAB_SPARSE)
    who = rng.choice(TAB_SPARSE, n, p=pw / pw.sum())
    S = np.zeros((n, TAB_SPARSE))
    S[np.arange(n), who] = rng.rand(n) + 0.1
    F += 1.2 * (who >= TAB_SPARSE // 2) \
        + 0.5 * ((who % 3) - 1) * S[np.arange(n), who]
    cols.extend(S.T)
    return np.column_stack(cols), F + 0.5 * rng.randn(n)


def _tab_dataset(gpt, X, y, **kw):
    return gpt.Dataset(X, label=y, categorical_feature=list(range(TAB_CAT)),
                       params={"enable_bundle": True}, **kw)


def _tab_params(kind, forced_path=None):
    if kind == "opts":
        return {**TAB, "monotone_constraints": TAB_MONO, **TAB_OPTS}
    if kind == "extra":
        return {**TAB, "monotone_constraints": TAB_MONO, "extra_trees": True,
                "forcedsplits_filename": forced_path}
    if kind == "255":
        return {**TAB, "monotone_constraints": TAB_MONO, "num_leaves": 255}
    return {**TAB, "monotone_constraints": TAB_MONO}


def _tree_syncs(torch, bst, what):
    """(host syncs of one steady round's tree, its splits) by torch's sync
    debug mode around the learner's train; they must be 1 + 1 a split +
    2 (the sites are printed where they are not)."""
    from collections import Counter
    res, sites = [], Counter()
    train = bst.learner.train

    def counted(*args, **kwargs):
        out, s = _count_syncs(torch, lambda: train(*args, **kwargs), sites)
        res.append((s, int(out[0].num_leaves) - 1))
        return out

    bst.learner.train = counted
    try:
        bst.update()
    finally:
        bst.learner.train = train
    syncs, splits = res[0]
    # a warning raised on the line where torch.cuda.set_sync_debug_mode
    # switches the mode back (once in some trees) is the counter's own
    # call, not the tree's
    import inspect
    fn = torch.cuda.set_sync_debug_mode
    lines, first = inspect.getsourcelines(fn)
    own = sites.pop(f"{os.path.relpath(inspect.getsourcefile(fn))}:"
                    + str(first + next(i for i, ln in enumerate(lines)
                                       if "_cuda_set_sync_debug_mode" in ln)),
                    0)
    syncs -= own
    if syncs != 1 + splits + 2:
        raise AssertionError(f"{what}: {syncs} host syncs in a tree of "
                             f"{splits} splits: " + ", ".join(
                                 f"{k} x{v}" for k, v in sites.items()))
    return syncs, splits


def _route_txt(histogram):
    r = histogram.hist_segment.routes
    return ", ".join(f"{k} x{v}" for k, v in sorted(r.items())) or "none"


def phase_tabular(torch, gpt, histogram, kernel_row):
    """Plain regression boosting on mixed tabular data at
    boosting_n200k_p50's shape (n = 200,000, p = 50: 10 categorical, 10
    with 20 % NaN, 10 dense, 20 sparse columns that EFB bundles into one
    int32 column of ~5,100 bins; monotone +1, +1, -1 on three dense
    columns): 20 rounds at 31 leaves and 10 at 255, then 10 rounds with
    path_smooth, interaction constraints and the coupled, split and lazy
    CEGB penalties and 10 with extra_trees and forced splits; pred_leaf
    and pred_contrib on 10,000 rows. Host syncs of a tree must be 1 + 1 a
    split + 2. Returns hist_segment's launches over the main path."""
    t0 = time.perf_counter()
    X, y = sim_tabular(N_TAB)
    ds = _tab_dataset(gpt, X, y)
    ds.construct()
    data_s = time.perf_counter() - t0
    if len(ds.bundles) != 1 or not ds.num_bins > histogram.WINDOW_BINS:
        raise AssertionError(f"tabular: {len(ds.bundles)} bundles, "
                             f"{ds.num_bins} bins")
    out, launches = {}, 0
    tmp = tempfile.mkdtemp()
    forced_path = os.path.join(tmp, "forced.json")
    with open(forced_path, "w") as f:
        json.dump(TAB_FORCED, f)
    models = {}
    try:
        for kind, rounds in (("31", ROUNDS_TAB), ("255", ROUNDS_TAB_255),
                             ("opts", ROUNDS_TAB_OPT),
                             ("extra", ROUNDS_TAB_OPT)):
            bst = gpt.Booster(_tab_params(kind, forced_path), ds,
                              device="cuda")
            _reset_launches(histogram)
            secs = []
            for _ in range(rounds):
                t = time.perf_counter()
                bst.update()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            launches += histogram.hist_segment.launches
            k_launches = histogram.hist_segment.launches
            routes = _route_txt(histogram)
            if not histogram.hist_segment.routes.get(
                    ("int32", histogram.bin_windows(ds.num_bins))):
                raise AssertionError(f"tabular {kind}: B1's wide int32 route "
                                     f"not taken ({routes})")
            syncs, splits = _tree_syncs(torch, bst, f"tabular {kind}")
            busy, wall, hist_s = _device_busy_s(
                torch, lambda: [bst.update() for _ in range(2)], cpu=False)
            models[kind] = bst
            p = bst.predict(X[:N_TAB_PRED])
            _finite(f"tabular {kind} predictions", p, (N_TAB_PRED,))
            r2 = 1.0 - np.var(y[:N_TAB_PRED] - p) / np.var(y[:N_TAB_PRED])
            print(f"[tabular] {CARD}: n={N_TAB} p={X.shape[1]} "
                  f"({len(ds.kept_features)} kept + 1 bundle, {ds.num_bins} "
                  f"bins, int32) {kind}: seconds a round " + ", ".join(
                      f"{v:.3f}" for v in secs)
                  + f" (mean {np.mean(secs):.4f}); host syncs of a tree "
                  f"{syncs} = 1 + {splits} splits + 2; device busy over 2 "
                  f"rounds {_busy_txt(busy, wall, hist_s)}; hist_segment "
                  f"launches {k_launches} ({routes}); R^2 on {N_TAB_PRED} "
                  f"rows {r2:.4f}", flush=True)
            if not r2 > TAB_MIN_R2:
                raise AssertionError(f"tabular {kind}: R^2 {r2:.3f}")
            out[kind] = float(np.mean(secs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bst = models["31"]
    for t in models["extra"].trees:
        if t.split_feature[0] != 20 or t.split_feature[t.left[0]] != 21:
            raise AssertionError("tabular extra: a forced split missing")
    used = {int(f) for t in models["31"].trees
            for f in t.split_feature[:t.num_nodes][~t.is_leaf[:t.num_nodes]]}
    kinds = {"categorical": bool(used & set(range(TAB_CAT))),
             "NaN": any(t.missing_bin[i] >= 0 for t in models["31"].trees
                        for i in range(t.num_nodes) if not t.is_leaf[i]),
             "bundle": 30 in used}
    if not all(kinds.values()):
        raise AssertionError(f"tabular: split kinds {kinds}")
    Xp = X[:N_TAB_PRED]
    t0 = time.perf_counter()
    leaf = bst.predict(Xp, pred_leaf=True)
    leaf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    contrib = bst.predict(Xp, pred_contrib=True)
    shap_s = time.perf_counter() - t0
    raw = bst.predict(Xp, raw_score=True)
    sum_err = float(np.max(np.abs(contrib.sum(1) - raw)))
    if leaf.shape != (N_TAB_PRED, ROUNDS_TAB + 3) \
            or contrib.shape != (N_TAB_PRED, X.shape[1] + 1) \
            or not sum_err <= 1e-6:
        raise AssertionError(f"tabular: pred_leaf {leaf.shape}, "
                             f"pred_contrib {contrib.shape}, rows sum to "
                             f"the raw prediction to {sum_err:.3g}")
    print(f"[tabular] {CARD}: data and binning {data_s:.2f} s; split kinds "
          f"{kinds}; "
          f"pred_leaf {leaf.shape} {leaf_s:.3f} s; pred_contrib "
          f"{contrib.shape} (TreeSHAP over {len(bst.trees)} trees) "
          f"{shap_s:.3f} s, rows sum to the raw prediction to "
          f"{sum_err:.3g}", flush=True)
    kernel_row["tabular_n200k_p50_s_a_round"] = out
    return launches


def phase_tabular_gpboost(torch, gpt, histogram):
    """GPBoost with a grouped random intercept (n = 100,000, q = 1,000,
    as examples/03) on the mixed tabular columns, 10 rounds at 31 leaves
    with the monotone constraints; 1,000 predictions, half in unseen
    groups. Returns hist_segment's launches."""
    X, F = sim_tabular(N_TAB_GP, seed=SEED_TAB + 1)
    rng = np.random.RandomState(SEED_TAB + 2)
    group = rng.randint(0, Q_TAB_GP, N_TAB_GP)
    y = F + 0.8 * rng.randn(Q_TAB_GP)[group]
    gp = gpt.GPModel(group_data=group, device="cuda")
    ds = _tab_dataset(gpt, X, y)
    bst = gpt.Booster(_tab_params("31"), ds, gp_model=gp, device="cuda")
    _reset_launches(histogram)
    secs = []
    for _ in range(ROUNDS):
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = histogram.hist_segment.launches
    syncs, splits = _tree_syncs(torch, bst, "tabular GPBoost")
    Xn = X[:N_PRED]
    gn = np.concatenate([group[:N_PRED // 2],
                         Q_TAB_GP + np.arange(N_PRED - N_PRED // 2)])
    pred = bst.predict(Xn, group_data_pred=gn, predict_var=True)
    cov = gp.get_cov_pars()
    _finite("tabular GPBoost cov pars", cov, (2,), positive=True)
    for k in ("response_mean", "response_var"):
        _finite(f"tabular GPBoost {k}", pred[k], (N_PRED,))
    var = pred["response_var"]
    if not np.min(var[N_PRED // 2:]) > np.max(var[:N_PRED // 2]) \
            or launches <= 0:
        raise AssertionError("tabular GPBoost: unseen groups' variances "
                             f"not above the seen ones', {launches} "
                             "launches")
    print(f"[tabular-gpboost] {CARD}: n={N_TAB_GP} q={Q_TAB_GP} "
          f"p={X.shape[1]} "
          f"({ds.num_bins} bins): first round {secs[0]:.3f} s (the first "
          f"GP fit), then mean {np.mean(secs[1:]):.4f} s a round; host syncs "
          f"of a tree {syncs} = 1 + {splits} + 2; cov pars {cov.tolist()}; "
          f"hist_segment launches {launches} ({_route_txt(histogram)})",
          flush=True)
    return launches


def _tab_compare(what, bc, bg, X):
    """Card booster bg against CPU booster bc grown from the same data:
    each node's split feature, bin, category bit set and, where a missing
    row reaches it, missing direction equal, or the first node that
    differs a float32 near tie (phase 5's rule: a relative gain gap below
    1e-5; later trees are then not compared); where every tree is equal,
    leaf values, predictions and pred_contrib to 1e-6 and pred_leaf
    exactly."""
    bins = bc.learner.bins_pos.numpy().astype(np.int64)
    for t, (a, b) in enumerate(zip(bc.trees, bg.trees)):
        reached = _tab_missing_reached(a, bins)
        for i in range(max(a.num_nodes, b.num_nodes)):
            if i >= min(a.num_nodes, b.num_nodes):
                raise AssertionError(f"{what}: tree {t} has {b.num_nodes} "
                                     f"nodes, not {a.num_nodes}")
            if a.is_leaf[i] and b.is_leaf[i]:
                continue
            diff = [k for k in ("is_leaf", "split_feature", "threshold_bin")
                    if getattr(a, k)[i] != getattr(b, k)[i]]
            if reached[i] and a.default_left[i] != b.default_left[i]:
                diff.append("default_left")
            ca, cb = a.cat_left_bins.get(i), b.cat_left_bins.get(i)
            if (ca is None) != (cb is None) or (
                    ca is not None and not np.array_equal(ca, cb)):
                diff.append("category set")
            if not diff:
                continue
            gap = abs(a.split_gain[i] - b.split_gain[i]) / max(
                abs(a.split_gain[i]), 1e-30)
            print(f"[{what}] tree {t} node {i}: {', '.join(diff)} differ "
                  f"(cpu feature {a.split_feature[i]} bin "
                  f"{a.threshold_bin[i]}, card {b.split_feature[i]} "
                  f"{b.threshold_bin[i]}), relative gain gap {gap:.3g}",
                  flush=True)
            if not gap < 1e-5:
                raise AssertionError(f"{what}: splits differ beyond an f32 "
                                     "near-tie")
            return f"near tie at tree {t} node {i}"
    errs = {"leaf values": max(float(np.max(np.abs(
        a.leaf_value[:a.num_nodes] - b.leaf_value[:b.num_nodes])))
        for a, b in zip(bc.trees, bg.trees)),
        "predictions": float(np.max(np.abs(bc.predict(X) - bg.predict(X)))),
        "pred_contrib": float(np.max(np.abs(
            bc.predict(X, pred_contrib=True)
            - bg.predict(X, pred_contrib=True))))}
    if not max(errs.values()) <= 1e-6 or not np.array_equal(
            bc.predict(X, pred_leaf=True), bg.predict(X, pred_leaf=True)):
        raise AssertionError(f"{what}: max |diff| {errs} or pred_leaf")
    return "all trees equal, pred_leaf equal; max |diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())


def _tab_missing_reached(tree, bins):
    """(nodes,) bool: a training row whose split value is missing reaches
    the node (elsewhere the two missing directions tie exactly)."""
    out = np.zeros(tree.num_nodes, dtype=bool)
    stack = [(0, np.arange(len(bins)))]
    while stack:
        i, rows = stack.pop()
        if tree.is_leaf[i]:
            continue
        b = bins[rows, tree.split_feature[i]]
        is_m = (tree.missing_bin[i] >= 0) & (b == tree.missing_bin[i])
        out[i] = bool(is_m.any())
        go = np.where(is_m, tree.default_left[i], b <= tree.threshold_bin[i])
        lb = tree.cat_left_bins.get(i)
        if lb is not None:
            go = lb[np.clip(b, 0, len(lb) - 1)]
        stack += [(tree.left[i], rows[go]), (tree.right[i], rows[~go])]
    return out


def phase_tabular_card_vs_cpu(torch, gpt, histogram, kernel_row):
    """Card against CPU at n = 2,000 with the options of phase 48 (the 31-
    leaf model, path_smooth + interaction constraints + CEGB, extra trees
    + forced splits; 3 rounds each), then B1 on the card at B = 5,121 (a
    20-member bundle, int32 codes, two bin windows) at n = 200,000:
    bitwise to its fixed-point emulation, across launches, under a row
    permutation, whole and half segments, and against the plain version,
    and at B = 4,096 (int32, one window) and 255 (uint8) on the same rows;
    the times of the three go into kernel_row under
    "at_tabular_n200k_p31_<codes>_b<B>"."""
    X, y = sim_tabular(N_TAB_CPU, seed=SEED_TAB + 3)
    tmp = tempfile.mkdtemp()
    forced_path = os.path.join(tmp, "forced.json")
    with open(forced_path, "w") as f:
        json.dump(TAB_FORCED, f)
    try:
        for kind in ("31", "opts", "extra"):
            bs, secs = {}, {}
            for dev in ("cpu", "cuda"):
                t0 = time.perf_counter()
                bs[dev] = gpt.train(_tab_params(kind, forced_path),
                                    _tab_dataset(gpt, X, y),
                                    num_boost_round=ROUNDS_TAB_CPU,
                                    device=dev)
                secs[dev] = time.perf_counter() - t0
            print(f"[tabular-card-vs-cpu] n={N_TAB_CPU} {kind}, "
                  f"{ROUNDS_TAB_CPU} rounds (card {secs['cuda']:.3f} s, cpu "
                  f"{secs['cpu']:.3f} s): "
                  + _tab_compare(f"tabular {kind}", bs["cpu"], bs["cuda"],
                                 X), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # B1 at B = 5,121: 30 kept columns of 255 bins and the bundle's codes
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED_TAB + 4)
    n, p = N_TAB, 31
    codes = np.empty((n, p), dtype=np.int32)
    codes[:, :30] = rng.randint(0, 255, size=(n, 30))
    member = rng.randint(0, 20, n)
    codes[:, 30] = 1 + 256 * member + rng.randint(0, 256, n)
    codes[rng.rand(n) < 0.05, 30] = 0
    stats = np.ones((n, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(n)
    stats[:, 1] = rng.rand(n) + 0.5
    bins = torch.as_tensor(codes, device=dev)
    stats_d = torch.as_tensor(stats, device=dev)
    gen = torch.Generator().manual_seed(SEED_TAB)
    err = 0.0
    for name, s0, cnt in (("whole", 0, n), ("half", 777, n // 2)):
        tol = 1e-5 * float(histogram.hist_segment_plain(
            bins, stats_d, s0, cnt, WIDE_BINS)[:, :2].abs().max())
        err = max(err, _segment_case(
            torch, histogram, f"hist_segment B={WIDE_BINS} int32 {name}",
            bins, stats_d, s0, cnt, WIDE_BINS, max(tol, 1e-5), gen))
    amax = histogram.stat_amax(stats_d, 0)
    # the same rows at the slice's other layouts: uint8 codes of 255 bins
    # and int32 codes of 4,096 bins (one window), beside the two windows
    layouts = [("int32", bins, WIDE_BINS),
               ("int32", torch.remainder(bins, 4096), 4096),
               ("uint8", torch.remainder(bins, 255).to(torch.uint8), 255)]
    for code, b, nb in layouts[1:]:
        err = max(err, _segment_case(
            torch, histogram, f"hist_segment B={nb} {code}", b, stats_d, 0,
            n, nb, 1e-5 * float(histogram.hist_segment_plain(
                b, stats_d, 0, n, nb)[:, :2].abs().max()), gen))
    for code, b, nb in layouts:
        def kernel():
            return histogram.hist_segment(b, stats_d, 0, n, nb, amax=amax)
        def plain():
            return histogram.hist_segment_plain(b, stats_d, 0, n, nb)
        row = dict(ms=_time_ms(torch, kernel),
                   device_ms=_device_ms(torch, kernel),
                   plain_ms=_time_ms(torch, plain, reps=10),
                   library_ms=_segment_library_ms(torch, b, stats_d, 0, n,
                                                  nb, kernel()),
                   max_abs_err=err)
        row["bound_ms"], row["bound_by"] = bound(
            b.element_size() * n * p + 12 * n + 12 * p * nb, 3 * n * p)
        kernel_row[f"at_tabular_n200k_p31_{code}_b{nb}"] = row
        print(f"[kernel] {CARD}: hist_segment n={n} p={p} B={nb} {code} "
              f"({histogram.bin_windows(nb)} bin windows): kernel "
              f"{row['ms']:.4f} ms by events, {_fmt_ms(row['device_ms'])} "
              f"device; plain {row['plain_ms']:.4f} ms; index_add_ "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
    print(f"[kernel] hist_segment B={WIDE_BINS}, 4096 and 255 at n={n}: "
          f"whole, half and permuted segments bitwise to the emulation, max "
          f"|err| {err:.3g} from the plain version", flush=True)


# ----------------------------------------------------------------------
# phases 51-53: the booster's modes (DART, GOSS, random forests, linear
# trees, refit) and its multi-output and ranking objectives (multiclass,
# mean_scale_regression, Grabit, lambdarank, rank_xendcg)
ROUNDS_MODES, ROUNDS_LINEAR, ROUNDS_MODES_OBJ = 20, 10, 10
N_MODES_PRED, N_MODES_VALID = 10_000, 20_000
MODES = {"dart": {"boosting": "dart", "drop_rate": 0.1, "max_drop": 50,
                  "skip_drop": 0.5},
         "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1},
         "rf": {"boosting": "rf", "bagging_fraction": 0.632,
                "bagging_freq": 1, "feature_fraction": 0.8},
         "linear": {"linear_tree": True}}
# host syncs of a round outside its trees' 1 + 1 a split + 2 each: the
# linear leaves' one read of their solutions
MODE_EXTRA_SYNCS = {"linear": 1}
# multiclass on sim_boost's features: the argmax of five seeded scores
K_MC, SEED_MC = 5, 31
# Grabit and mean-scale: friedman3 of tests/test_grabit_meanscale.py:30-51
N_GRABIT, GRABIT_YL, GRABIT_YU = 200_000, 3.5, 4.8
FRIEDMAN3_HELD_OUT = (0.31415, 0.27182)
# mean_scale_regression's label: friedman3's f plus Gaussian noise whose
# sd grows from 0.05 to 0.3 with the first irrelevant column, so that the
# variance trees have a signal. On the clipped Grabit label the
# variance's Newton step diverges from n = 134,456 on, in the JAX package
# as in the port: a leaf of near-constant residuals takes a step of
# hundreds, and the next round's gradients pass float32's range in the
# histograms.
SEED_MS = 37


def mean_scale_label(X, f, seed=SEED_MS):
    """(label, noise sd) of mean_scale_regression on friedman3 rows."""
    sd = 0.05 + 0.25 * X[:, 5]
    return f + sd * np.random.RandomState(seed).randn(len(f)), sd
# ranking at MSLR-WEB10K's widths (136 features, relevance 0-4, queries of
# 40-200 documents), cut to 200,000 documents; features with 200 levels,
# relevance by a query's utility quantiles at the set's label shares
N_RANK, P_RANK, SEED_RANK, RANK_LEN = 200_000, 136, 41, (40, 200)
RANK_SHARES = (0.52, 0.84, 0.97, 0.99)
# phase 53: card against CPU at n = 2,000; DART drops in its round 5 and
# GOSS samples after its 10 warm-up rounds
N_MODES_CPU, ROUNDS_MODES_CPU = 2_000, {"dart": 5, "goss": 12}


def _with_label(ds, y):
    """A shallow copy of a binned Dataset with other labels."""
    import copy
    out = copy.copy(ds)
    out.set_label(y)
    return out


def _r2(y, p):
    return 1.0 - np.var(y - p) / np.var(y)


def _record_draws(bst, masks=True):
    """{"drop": each round's DART drop set, "mask": the row mask (bagging
    or GOSS) of each tree, copied to the host, or None, "goss": each GOSS
    call's (bagging RandomState's state, grad, hess) on the host}, filled
    as bst trains; masks=False records the drop sets alone (no host
    read)."""
    log = {"drop": [], "mask": [], "goss": []}
    drop, train, goss = bst._dart_drop, bst.learner.train, bst._goss_mask

    def dart():
        out = drop()
        log["drop"].append(list(out[0]))
        return out

    def learn(*args, **kwargs):
        m = kwargs.get("row_mask")
        log["mask"].append(None if m is None else m.cpu().numpy())
        return train(*args, **kwargs)

    def goss_mask(grad, hess):
        log["goss"].append((bst._bag_rng.get_state(), grad.cpu().numpy(),
                            hess.cpu().numpy()))
        return goss(grad, hess)

    bst._dart_drop = dart
    if masks:
        bst.learner.train = learn
        bst._goss_mask = goss_mask
    return log


def _goss_near_tie(torch, lc, lg, bc, bg):
    """Where the GOSS row masks of CPU and card first differ, at round j:
    the trees before it are compared (`_modes_compare`). Unless they hold
    a split near tie, the |grad hess| keys of round j must agree to 1e-6
    (two orders of keys that agree to d differ only among rows whose keys
    lie within 2 d), and the card's `_goss_mask` on the CPU's gradients
    and RandomState must give the CPU's mask exactly. Returns None when
    every mask is equal, else (j, what was found)."""
    j = next((i for i, (mc, mg) in enumerate(zip(lc["mask"], lg["mask"]))
              if (mc is None) != (mg is None) or (
                  mc is not None and not np.array_equal(mc, mg))), None)
    if j is None:
        return None
    before = _modes_compare("modes goss", bc, bg, None, j)
    if before.startswith("near tie"):
        return j, before
    (state, gc, hc), (_, gg, hg) = lc["goss"][j], lg["goss"][j]
    kc, kg = np.abs(gc * hc), np.abs(gg * hg)
    d = float(np.max(np.abs(kc - kg)))
    moved = int(np.sum(np.argsort(-kc, kind="stable")
                       != np.argsort(-kg, kind="stable")))
    rng = bg._bag_rng.get_state()
    bg._bag_rng.set_state(state)
    m = bg._goss_mask(torch.as_tensor(gc, device=bg.device),
                      torch.as_tensor(hc, device=bg.device))
    bg._bag_rng.set_state(rng)
    same = m is not None and np.array_equal(m.cpu().numpy(), lc["mask"][j])
    if not (d <= 1e-6 and moved > 0 and same):
        raise AssertionError(f"modes card vs cpu goss: round {j}'s row masks "
                             f"differ (keys to {d:.3g}, {moved} rows in "
                             f"another place, the card's mask on the CPU's "
                             f"gradients {'equal' if same else 'differs'})")
    return j, (f"{before}; round {j}'s row masks differ at a near tie: "
               f"|grad hess| to {d:.3g}, {moved} rows in another place, "
               "the card's mask on the CPU's gradients equal")


def _round_syncs(torch, bst, what, extra=0):
    """(host syncs of one round, [(syncs, splits)] of its trees, syncs
    outside them) by torch's sync debug mode around bst.update(): each
    tree must make 1 + 1 a split + 2 and the rest of the round `extra`
    (the sites are printed where not)."""
    import inspect
    import warnings
    from collections import Counter
    trees, train = [], bst.learner.train
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*args, **kwargs):
            n0 = len(caught)
            out = train(*args, **kwargs)
            trees.append((sum("synchroniz" in str(w.message)
                              for w in caught[n0:]),
                          int(out[0].num_leaves) - 1))
            return out

        bst.learner.train = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            bst.update()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            bst.learner.train = train
    sites = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message))
    # the warning of the mode switch back is the counter's own (phase 48)
    fn = torch.cuda.set_sync_debug_mode
    lines, first = inspect.getsourcelines(fn)
    sites.pop(f"{os.path.relpath(inspect.getsourcefile(fn))}:"
              + str(first + next(i for i, ln in enumerate(lines)
                                 if "_cuda_set_sync_debug_mode" in ln)), 0)
    total = sum(sites.values())
    outside = total - sum(s for s, _ in trees)
    if any(s != 1 + k + 2 for s, k in trees) or outside != extra:
        raise AssertionError(f"{what}: {total} host syncs in a round, trees "
                             f"(syncs, splits) {trees}, {outside} outside "
                             f"them, not {extra}: " + ", ".join(
                                 f"{k} x{v}" for k, v in sites.items()))
    return total, trees, outside


def _sync_txt(total, trees, outside):
    return (f"{total} = " + " + ".join(f"(1 + {k} + 2)" for _, k in trees)
            + f" + {outside}")


def _mode_rounds(torch, bst, rounds, histogram, what, extra=0):
    """Time `rounds` rounds of bst, then the host syncs of one and the
    device busy share of two more: (seconds a round, B1 launches of the
    timed rounds, sync text, busy text)."""
    _reset_launches(histogram)
    secs = []
    for _ in range(rounds):
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = histogram.hist_segment.launches
    if launches <= 0:
        raise AssertionError(f"{what}: no hist_segment launch")
    syncs = _sync_txt(*_round_syncs(torch, bst, what, extra))
    busy, wall, hist_s = _device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)], cpu=False)
    return secs, launches, syncs, _busy_txt(busy, wall, hist_s)


def _secs_txt(secs):
    return (", ".join(f"{v:.3f}" for v in secs)
            + f" (mean {np.mean(secs):.4f})")


def phase_modes(torch, gpt, histogram, ds, X, y, kernel_row):
    """The boosting modes on boosting_n200k_p50 (sim_boost, n = 200,000,
    p = 50, seed 2, 31 leaves, learning rate 0.1): plain gbdt 20 rounds,
    DART (drop_rate 0.1, max_drop 50, skip_drop 0.5) 20, GOSS (top_rate
    0.2, other_rate 0.1) 20 (10 past its warm-up), a random forest
    (bagging 0.632 every round, feature_fraction 0.8) 20 trees, linear
    trees 10; then refit of the gbdt model on a second draw of 200,000
    rows. For each: seconds a round, host syncs of a round (each tree
    1 + 1 a split + 2, linear leaves one more read), device busy share of
    two more rounds, B1 launches (> 0), R^2 on 10,000 held-out rows
    (> 0.1). DART must drop a tree; the forest's training score must be
    its trees' mean to 1e-10. Returns B1's launches over the timed
    rounds."""
    ds = _with_label(ds, y)
    Xh, yh = sim_boost(N_MODES_PRED, seed=SEED_BOOST + 10)
    launches, out, models = 0, {}, {}
    for kind in ("gbdt", "dart", "goss", "rf", "linear"):
        bst = gpt.Booster({**BOOST, **MODES.get(kind, {})}, ds,
                          device="cuda")
        rounds = ROUNDS_LINEAR if kind == "linear" else ROUNDS_MODES
        drops = _record_draws(bst, masks=False)["drop"]
        secs, k_launches, syncs, busy = _mode_rounds(
            torch, bst, rounds, histogram, f"modes {kind}",
            MODE_EXTRA_SYNCS.get(kind, 0))
        launches += k_launches
        r2 = _r2(yh, bst.predict(Xh))
        extra = ""
        if kind == "dart":
            # the first round drops nothing and draws nothing
            dropped = [(i + 1, d) for i, d in enumerate(drops[:rounds - 1])
                       if d]
            if not dropped:
                raise AssertionError("modes dart: no tree dropped")
            extra = "; rounds that dropped (round, trees) " + ", ".join(
                f"({i}, {d})" for i, d in dropped)
        if kind == "rf":
            err = float(np.max(np.abs(bst.F.cpu().numpy() - bst.predict(X))))
            if not err <= 1e-10:
                raise AssertionError(f"modes rf: training score off the "
                                     f"trees' mean by {err:.3g}")
            extra = f"; training score = trees' mean to {err:.3g}"
        if kind == "linear":
            nlin = sum(len(t.leaf_linear) for t in bst.trees)
            if not nlin:
                raise AssertionError("modes linear: no linear leaf")
            extra = f"; {nlin} linear leaves"
        print(f"[modes] {CARD}: n={N_BOOST} p={P_BOOST} {kind}: seconds a "
              f"round {_secs_txt(secs)}; host syncs of a round {syncs}; "
              f"device busy over 2 rounds {busy}; hist_segment launches "
              f"{k_launches}; R^2 on {N_MODES_PRED} held-out rows "
              f"{r2:.4f}{extra}", flush=True)
        if not r2 > TAB_MIN_R2:
            raise AssertionError(f"modes {kind}: R^2 {r2:.3f}")
        out[kind] = float(np.mean(secs))
        models[kind] = bst
    X2, y2 = sim_boost(N_BOOST, seed=SEED_BOOST + 11)
    t0 = time.perf_counter()
    ref = models["gbdt"].refit(X2, y2)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    p = ref.predict(Xh)
    r2 = _r2(yh, p)
    if not r2 > TAB_MIN_R2 or len(ref.trees) != len(models["gbdt"].trees):
        raise AssertionError(f"modes refit: R^2 {r2:.3f}")
    print(f"[modes] {CARD}: refit of the gbdt model's "
          f"{len(ref.trees)} trees on {N_BOOST} new rows in {refit_s:.3f} s "
          f"(decay {models['gbdt'].params['refit_decay_rate']}); R^2 on "
          f"{N_MODES_PRED} held-out rows {r2:.4f}", flush=True)
    kernel_row["modes_n200k_p50_s_a_round"] = out
    return launches


def friedman3_fast(n, n_irr=5, starts=(0.54234, 0.74534)):
    """tests/test_grabit_meanscale.py friedman3 with its LCG stepped in
    blocks (s_{i+k} = (a^k s_i + c (a^k - 1) / (a - 1)) mod m, exact in
    int64); `starts` are the LCG's start values of the four friedman3
    columns and of the irrelevant ones. The LCG's period is 134,456, so
    at n = 200,000 row i + 134,456 repeats row i."""
    def unif(count, init_c):
        mod, a, c, blk = 134456, 8121, 28411, 4096
        A, C = np.ones(blk, dtype=np.int64), np.zeros(blk, dtype=np.int64)
        for k in range(1, blk):
            A[k] = A[k - 1] * a % mod
            C[k] = (C[k - 1] * a + c) % mod
        out = np.empty(count, dtype=np.int64)
        s = int(np.floor(init_c * mod))
        for i in range(0, count, blk):
            m = min(blk, count - i)
            out[i:i + m] = (A[:m] * s + C[:m]) % mod
            s = int((a * out[i + m - 1] + c) % mod)
        return out / mod

    if not np.array_equal(unif(5_000, 0.54234), lcg_unif(5_000, 0.54234)):
        raise AssertionError("friedman3: the blocked LCG differs")
    X = np.reshape(unif(4 * n, starts[0]), (4, n)).T.copy()
    X[:, 0] *= 100
    X[:, 1] = X[:, 1] * np.pi * (560 - 40) + 40 * np.pi
    X[:, 3] = X[:, 3] * 10 + 1
    f = np.sqrt(10) * np.arctan(
        (X[:, 1] * X[:, 2] - 1 / (X[:, 1] * X[:, 3])) / X[:, 0])
    X = np.column_stack([np.ones(n), X])
    X = np.column_stack(
        [X, np.reshape(unif(n_irr * n, starts[1]), (n_irr, n)).T])
    return X, f


def sim_rank(n, seed=SEED_RANK):
    """Ranking data at MSLR-WEB10K's widths: queries of RANK_LEN
    documents (the last one takes the rest), P_RANK features of 200
    levels, relevance 0-4 by each query's quantiles of a utility of 10
    features plus noise, at the shares RANK_SHARES."""
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < n:
        lens.append(rng.randint(RANK_LEN[0], RANK_LEN[1] + 1))
    lens[-1] -= sum(lens) - n
    lens = np.asarray(lens)
    X = np.floor(rng.rand(n, P_RANK) * 200)
    util = X[:, :10] @ rng.randn(10) / 200 + 0.5 * rng.randn(n)
    q = np.repeat(np.arange(len(lens)), lens)
    order = np.lexsort((util, q))
    rank = np.empty(n)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rank[order] = np.arange(n) - np.repeat(starts, lens)
    frac = (rank + 0.5) / np.repeat(lens, lens)
    return X, np.digitize(frac, RANK_SHARES).astype(float), lens


def _ndcg_at(y, F, lens, k=10):
    from gpboost_tpu_torch.boosting.ranking import (ndcg_metric,
                                                    query_boundaries)
    return ndcg_metric(y, F, query_boundaries(lens), [k])[k]


def phase_modes_objectives(torch, gpt, histogram, ds, X, kernel_row):
    """The multi-output and ranking objectives at full width: multiclass
    (K = 5) on sim_boost's features with labels the argmax of five seeded
    scores, 10 rounds (50 trees), multi_logloss on a 20,000-row
    validation set, pred_early_stop and pred_contrib on 10,000 rows;
    mean_scale_regression (`mean_scale_label`: friedman3's f with noise of
    a varying sd) and Grabit (tobit, yl 3.5, yu 4.8) on friedman3 at n =
    200,000, 10 rounds; lambdarank and rank_xendcg on ranking data
    at MSLR-WEB10K's widths (n = 200,000, 136 features, ~1,670 queries),
    10 rounds with ndcg@10 on 20,000 validation documents, and the
    ranking gradients' device time beside the numpy version's. Seconds a
    round, host syncs of a round, device busy share and B1 launches as in
    phase 51. Returns B1's launches over the timed rounds."""
    from gpboost_tpu_torch.boosting import ranking
    launches, out = 0, {}
    rng = np.random.RandomState(SEED_MC)
    W = rng.randn(P_BOOST, K_MC)
    Xv, _ = sim_boost(N_MODES_VALID, seed=SEED_BOOST + 12)

    def mc_label(A, r):
        return np.argmax((A[:, :10] - 0.5) @ W[:10]
                         + 0.5 * r.randn(len(A), K_MC), 1).astype(float)
    ymc, yv = mc_label(X, rng), mc_label(Xv, rng)

    def report(kind, bst, secs, k_launches, syncs, busy, quality):
        print(f"[modes-objectives] {CARD}: {kind}: seconds a round "
              f"{_secs_txt(secs)}; host syncs of a round {syncs}; device "
              f"busy over 2 rounds {busy}; hist_segment launches "
              f"{k_launches}; {quality}", flush=True)
        out[kind.split()[0]] = float(np.mean(secs))

    # multiclass with its validation set, through train
    params = {**BOOST, "objective": "multiclass", "num_class": K_MC,
              "metric": "multi_logloss"}
    ev = {}
    _reset_launches(histogram)
    with _RoundClock(torch, gpt) as clock:
        bst = gpt.train(params, _with_label(ds, ymc), ROUNDS_MODES_OBJ,
                        valid_sets=[gpt.Dataset(Xv, label=yv, reference=ds)],
                        evals_result=ev, callbacks=[clock.callback()],
                        device="cuda")
    k_launches = histogram.hist_segment.launches
    launches += k_launches
    ll = ev["valid_0"]["multi_logloss"]
    acc = float(np.mean(bst.predict(Xv).argmax(1) == yv))
    if not (k_launches > 0 and ll[-1] < ll[0] and acc > 1.0 / K_MC + 0.1):
        raise AssertionError(f"multiclass: logloss {ll}, accuracy {acc}")
    syncs = _sync_txt(*_round_syncs(torch, bst, "multiclass"))
    busy = _busy_txt(*_device_busy_s(
        torch, lambda: [bst.update() for _ in range(2)], cpu=False))
    Xp = X[:N_MODES_PRED]
    raw = bst.predict(Xp, raw_score=True)
    t0 = time.perf_counter()
    contrib = bst.predict(Xp, pred_contrib=True)
    shap_s = time.perf_counter() - t0
    sum_err = float(np.max(np.abs(
        contrib.reshape(N_MODES_PRED, K_MC, -1).sum(2) - raw)))
    es = bst.predict(Xp, pred_early_stop=True, pred_early_stop_freq=2,
                     pred_early_stop_margin=1.0)
    agree = float(np.mean(es.argmax(1) == raw.argmax(1)))
    if contrib.shape != (N_MODES_PRED, K_MC * (P_BOOST + 1)) \
            or not sum_err <= 1e-6 or not agree >= 0.99:
        raise AssertionError(f"multiclass: pred_contrib {contrib.shape}, "
                             f"sum {sum_err:.3g}; early stop agrees on "
                             f"{agree:.4f}")
    report(f"multiclass K={K_MC} n={N_BOOST} p={P_BOOST}", bst,
           clock.update_s, k_launches, syncs, busy,
           f"{clock.txt()}; multi_logloss on {N_MODES_VALID} rows "
           f"{ll[0]:.4f} -> {ll[-1]:.4f}, accuracy {acc:.4f}; pred_contrib "
           f"{contrib.shape} in {shap_s:.3f} s, blocks sum to the raw "
           f"scores to {sum_err:.3g}; pred_early_stop (freq 2, margin 1) "
           f"agrees with the full prediction on {agree:.4f} of the rows")
    # mean-scale and Grabit on friedman3
    Xf, f = friedman3_fast(N_GRABIT)
    yf = np.clip(f, GRABIT_YL, GRABIT_YU)
    # the held-out rows from other LCG starts: no row of them is a
    # training row (a tail of the training sequence would repeat rows)
    Xh, fh = friedman3_fast(N_MODES_PRED, starts=FRIEDMAN3_HELD_OUT)
    yh = np.clip(fh, GRABIT_YL, GRABIT_YU)
    if set(map(tuple, Xh[:, 1:5])) & set(map(tuple, Xf[:, 1:5])):
        raise AssertionError("friedman3: held-out rows among the training "
                             "rows")
    dsf = gpt.Dataset(Xf, label=yf)
    dsf.construct()
    yms, _ = mean_scale_label(Xf, f)
    yhms, sdh = mean_scale_label(Xh, fh, seed=SEED_MS + 1)
    for kind, params, dsk in (
            ("mean_scale_regression", {"objective": "mean_scale_regression"},
             _with_label(dsf, yms)),
            ("tobit", {"objective": "tobit", "yl": GRABIT_YL,
                       "yu": GRABIT_YU}, dsf)):
        bst = gpt.Booster({**BOOST, **params}, dsk, device="cuda")
        secs, k_launches, syncs, busy = _mode_rounds(
            torch, bst, ROUNDS_MODES_OBJ, histogram, kind)
        launches += k_launches
        pred = bst.predict(Xh)
        if kind == "tobit":
            r2 = _r2(fh, pred)
            quality = f"R^2 against the latent f on {N_MODES_PRED} held-out"
        else:
            _finite("mean_scale pred_var", pred["pred_var"],
                    (N_MODES_PRED,), positive=True)
            r2 = _r2(yhms, pred["pred_mean"])
            # the variance trees follow the noise's sd
            rho = float(np.corrcoef(np.log(pred["pred_var"]),
                                    np.log(sdh))[0, 1])
            if not rho > 0.1:
                raise AssertionError(f"mean_scale: corr(log pred_var, "
                                     f"log sd) {rho:.3f}")
            quality = (f"corr(log pred_var, log sd) {rho:.4f}; R^2 of "
                       f"pred_mean on {N_MODES_PRED} held-out")
        if not r2 > TAB_MIN_R2:
            raise AssertionError(f"{kind}: R^2 {r2:.3f}")
        report(f"{kind} n={N_GRABIT}", bst, secs, k_launches, syncs, busy,
               f"{quality} rows {r2:.4f}")
    # the ranking objectives
    t0 = time.perf_counter()
    Xr, yr, lens = sim_rank(N_RANK + N_MODES_VALID)
    nq = int(np.searchsorted(np.cumsum(lens), N_RANK, side="right"))
    ntr = int(np.sum(lens[:nq]))
    dsr = gpt.Dataset(Xr[:ntr], label=yr[:ntr], group=lens[:nq])
    dsr.construct()
    dvr = gpt.Dataset(Xr[ntr:], label=yr[ntr:], group=lens[nq:],
                      reference=dsr)
    data_s = time.perf_counter() - t0
    for kind in ("lambdarank", "rank_xendcg"):
        ev = {}
        _reset_launches(histogram)
        with _RoundClock(torch, gpt) as clock:
            bst = gpt.train({**BOOST, "objective": kind, "eval_at": [10]},
                            dsr, ROUNDS_MODES_OBJ, valid_sets=[dvr],
                            evals_result=ev, callbacks=[clock.callback()],
                            device="cuda")
        k_launches = histogram.hist_segment.launches
        launches += k_launches
        nd = ev["valid_0"]["ndcg@10"]
        base = _ndcg_at(yr[ntr:], np.zeros(len(yr) - ntr), lens[nq:])
        if not (k_launches > 0 and nd[-1] > base + 0.05):
            raise AssertionError(f"{kind}: ndcg@10 {nd}, base {base}")
        syncs = _sync_txt(*_round_syncs(torch, bst, kind))
        busy = _busy_txt(*_device_busy_s(
            torch, lambda: [bst.update() for _ in range(2)], cpu=False))
        lay, F = bst._rank, bst.F
        if kind == "lambdarank":
            def dev():
                return lay.lambdarank(F)

            def host():
                return ranking.lambdarank_gradients(
                    yr[:ntr], Fh, ranking.query_boundaries(lens[:nq]))
        else:
            def dev():
                return lay.xendcg(F)

            def host():
                return ranking.xendcg_gradients(
                    yr[:ntr], Fh, ranking.query_boundaries(lens[:nq]),
                    seed=int(bst.params["objective_seed"]))
        Fh = F.cpu().numpy()
        grad_ms = _time_ms(torch, dev, reps=10)
        t0 = time.perf_counter()
        gh, hh = host()
        host_ms = (time.perf_counter() - t0) * 1e3
        gd, hd = (t.cpu().numpy() for t in dev())
        gerr = max(float(np.max(np.abs(gd - gh))),
                   float(np.max(np.abs(hd - hh))))
        if not gerr <= 1e-12:
            raise AssertionError(f"{kind}: device gradients off the numpy "
                                 f"version by {gerr:.3g}")
        report(f"{kind} n={ntr} p={P_RANK} {nq} queries", bst,
               clock.update_s, k_launches, syncs, busy,
               f"{clock.txt()}; ndcg@10 on {len(yr) - ntr} validation "
               f"documents {nd[0]:.4f} -> {nd[-1]:.4f} (zero scores "
               f"{base:.4f}); gradients {grad_ms:.3f} ms on the card by "
               f"events, numpy {host_ms:.1f} ms on the host, max |diff| "
               f"{gerr:.3g}; data and binning {data_s:.2f} s")
    kernel_row["modes_objectives_s_a_round"] = out
    return launches


def _modes_compare(what, bc, bg, X, trees=None):
    """Card booster bg against CPU booster bc: every node's split feature
    and bin equal, or the first difference a float32 near tie (phase 5's
    rule; later trees are then not compared); else leaf values and
    slopes to 1e-6, and the training score and predictions, which sum a
    block's trees, to 1e-6 a tree they sum (the float32 histogram sums'
    rounding moves a Grabit leaf by up to 6.5e-7 at n = 2,000). With
    `trees`, only the first `trees` trees (those before a GOSS near tie),
    their splits and leaf values."""
    if trees is not None:
        bc = types.SimpleNamespace(trees=bc.trees[:trees])
        bg = types.SimpleNamespace(trees=bg.trees[:trees])
    for t, (a, b) in enumerate(zip(bc.trees, bg.trees)):
        for i in range(max(a.num_nodes, b.num_nodes)):
            if i >= min(a.num_nodes, b.num_nodes):
                raise AssertionError(f"{what}: tree {t} has {b.num_nodes} "
                                     f"nodes, not {a.num_nodes}")
            if a.is_leaf[i] and b.is_leaf[i]:
                continue
            if all(getattr(a, k)[i] == getattr(b, k)[i] for k in
                   ("is_leaf", "split_feature", "threshold_bin")):
                continue
            gap = abs(a.split_gain[i] - b.split_gain[i]) / max(
                abs(a.split_gain[i]), 1e-30)
            print(f"[{what}] tree {t} node {i} differs (cpu feature "
                  f"{a.split_feature[i]} bin {a.threshold_bin[i]}, card "
                  f"{b.split_feature[i]} {b.threshold_bin[i]}), relative "
                  f"gain gap {gap:.3g}", flush=True)
            if not gap < 1e-5:
                raise AssertionError(f"{what}: splits differ beyond an f32 "
                                     "near tie")
            return f"near tie at tree {t} node {i}"
    errs = {"leaf values": 0.0, "slopes": 0.0}
    for a, b in zip(bc.trees, bg.trees):
        errs["leaf values"] = max(errs["leaf values"], float(np.max(np.abs(
            a.leaf_value[:a.num_nodes] - b.leaf_value[:b.num_nodes]))))
        if sorted(a.leaf_linear) != sorted(b.leaf_linear):
            raise AssertionError(f"{what}: linear leaves differ")
        for k, (fa, ca) in a.leaf_linear.items():
            fb, cb = b.leaf_linear[k]
            if not np.array_equal(fa, fb):
                raise AssertionError(f"{what}: leaf {k}'s features differ")
            errs["slopes"] = max(errs["slopes"],
                                 float(np.max(np.abs(ca - cb))))
    if trees is not None:
        if not max(errs.values()) <= 1e-6:
            raise AssertionError(f"{what}: max |diff| {errs}")
        return f"the {trees} trees before it equal; max |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
    if not max(errs.values()) <= 1e-6:
        raise AssertionError(f"{what}: max |diff| {errs}")
    per = max(1, len(bc.trees) // bc._nsets)
    sums = {"training score": float((bg.F.cpu() - bc.F).abs().max())}
    pa, pb = bc.predict(X), bg.predict(X)
    if isinstance(pa, dict):
        sums["predictions"] = max(float(np.max(np.abs(pa[k] - pb[k])))
                                  for k in pa)
    else:
        sums["predictions"] = float(np.max(np.abs(pa - pb)))
    if not max(sums.values()) <= 1e-6 * per:
        raise AssertionError(f"{what}: max |diff| {errs}, {sums} over "
                             f"{per} trees a block")
    return "all trees equal; max |diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in {**errs, **sums}.items()) \
        + f" ({per} trees a block)"


def phase_modes_card_vs_cpu(torch, gpt):
    """Card against CPU at n = 2,000 for the nine models of phases 51-52,
    3 rounds each (DART 5, so that it drops; GOSS 12, two past its
    warm-up): trees under phase 5's near-tie rule, else leaf values,
    slopes, training score and predictions to 1e-6; DART's drop sets and
    the GOSS and random-forest row masks of every round equal, or the
    first GOSS difference a near tie of |grad hess| (`_goss_near_tie`;
    only the trees before it are then compared); the
    lambdarank and rank_xendcg gradients on both devices at the CPU's
    final score to 1e-12. Mean-scale trains on the clipped friedman3
    label here, as tests/test_grabit_meanscale.py does (its divergence
    starts at n = 134,456): on `mean_scale_label` its first variance
    leaves reach ~6, where the float32 histogram sums' rounding alone
    passes 1e-6."""
    Xb, yb = sim_boost(N_MODES_CPU, seed=SEED_BOOST + 13)
    ymc = np.argmax(Xb[:, :K_MC] + 0.3 * np.random.RandomState(
        SEED_MC).randn(N_MODES_CPU, K_MC), 1).astype(float)
    Xf, f = friedman3_fast(N_MODES_CPU)
    Xr, yr, lens = sim_rank(N_MODES_CPU, seed=SEED_RANK + 1)
    runs = [(k, {**BOOST, **MODES[k]}, Xb, yb, {}) for k in MODES]
    runs += [("multiclass", {**BOOST, "objective": "multiclass",
                             "num_class": K_MC}, Xb, ymc, {}),
             ("mean_scale_regression", {**BOOST, "objective":
                                        "mean_scale_regression"},
              Xf, np.clip(f, GRABIT_YL, GRABIT_YU), {}),
             ("tobit", {**BOOST, "objective": "tobit", "yl": GRABIT_YL,
                        "yu": GRABIT_YU}, Xf,
              np.clip(f, GRABIT_YL, GRABIT_YU), {}),
             ("lambdarank", {**BOOST, "objective": "lambdarank"}, Xr, yr,
              {"group": lens}),
             ("rank_xendcg", {**BOOST, "objective": "rank_xendcg"}, Xr, yr,
              {"group": lens})]
    for kind, params, Xk, yk, kw in runs:
        rounds = ROUNDS_MODES_CPU.get(kind, 3)
        bs, logs, secs = {}, {}, {}
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            bst = gpt.Booster(params, gpt.Dataset(Xk, label=yk, **kw),
                              device=dev)
            logs[dev] = _record_draws(bst)
            for _ in range(rounds):
                bst.update()
            secs[dev] = time.perf_counter() - t0
            bs[dev] = bst
        lc, lg = logs["cpu"], logs["cuda"]
        tie = _goss_near_tie(torch, lc, lg, bs["cpu"], bs["cuda"]) \
            if kind == "goss" else None
        if lc["drop"] != lg["drop"] or len(lc["mask"]) != len(lg["mask"]) \
                or tie is None and any((mc is None) != (mg is None) or (
                    mc is not None and not np.array_equal(mc, mg))
                    for mc, mg in zip(lc["mask"], lg["mask"])):
            raise AssertionError(f"modes card vs cpu {kind}: the drop sets "
                                 "or the row masks differ")
        draws = ""
        if kind == "dart":
            draws = f"; drop sets {lc['drop']}"
            if not any(lc["drop"]):
                raise AssertionError("modes card vs cpu dart: no drop")
        if kind in ("goss", "rf"):
            masked = sum(m is not None for m in lc["mask"])
            if not masked:
                raise AssertionError(f"modes card vs cpu {kind}: no mask")
            draws = f"; {masked} rounds' row masks equal"
            if tie is not None:
                draws = f"; row masks equal before round {tie[0]}"
        if kind in ("lambdarank", "rank_xendcg"):
            F = bs["cpu"].F
            fn = "lambdarank" if kind == "lambdarank" else "xendcg"
            gc = getattr(bs["cpu"]._rank, fn)(F)
            gg = getattr(bs["cuda"]._rank, fn)(F.to(bs["cuda"].device))
            gerr = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(gg, gc))
            if not gerr <= 1e-12:
                raise AssertionError(f"modes card vs cpu {kind}: gradients "
                                     f"differ by {gerr:.3g}")
            draws = f"; gradients at one score max |diff| {gerr:.3g}"
        print(f"[modes-card-vs-cpu] n={N_MODES_CPU} {kind}, {rounds} rounds "
              f"(card {secs['cuda']:.3f} s, cpu {secs['cpu']:.3f} s): "
              + (tie[1] if tie is not None else _modes_compare(
                  f"modes {kind}", bs["cpu"], bs["cuda"], Xk))
              + draws, flush=True)


# the groups of phases that run together; --phases runs every group that
# holds one of the phases asked for (phases 1 and 2 always run)
GROUPS = ((3, 8), (9, 14), (15, 19), (20, 22), (23, 23), (24, 24),
          (25, 25), (26, 26), (27, 29), (30, 32), (33, 35), (36, 38),
          (39, 41), (42, 44), (45, 47), (48, 50), (51, 53))


def _print_phase_time(fn):
    """fn, printing its seconds as "[time] <name> <s> s" when it returns
    or raises."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"[time] {fn.__name__} {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return run


# every phase prints its own seconds
for _name, _fn in list(globals().items()):
    if _name.startswith("phase_") and callable(_fn):
        globals()[_name] = _print_phase_time(_fn)


def _groups(spec):
    """The groups to run for a --phases spec such as "23-26" or "5,24";
    all of them for None."""
    if spec is None:
        return set(GROUPS)
    want = set()
    for part in spec.split(","):
        a, _, b = part.partition("-")
        want.update(range(int(a), int(b or a) + 1))
    return {g for g in GROUPS if want & set(range(g[0], g[1] + 1))}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", help="run only the groups of phases that "
                    "hold these (e.g. 23-26; 1 and 2 always run); prints "
                    "no result lines")
    ap.add_argument("--vlb-maxit", type=int, default=MAXIT_VLB_ITER,
                    help="phase 25's cap on the first GP fit's iterations "
                    "(0: none)")
    args = ap.parse_args(argv)
    groups = _groups(args.phases)
    import torch
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import histogram

    phase_device(torch)
    phase_build(histogram)
    segment, masked, block = {}, {}, {}
    ds = None
    if (3, 8) in groups:
        segment = phase_kernel(torch, gpt, histogram)
        segment["launches"] = phase_slice(torch, gpt, histogram)
        phase_card_vs_cpu(torch, gpt)
        X, y = sim_boost()
        t0 = time.perf_counter()
        ds = gpt.Dataset(X, label=y)
        ds.construct()
        print(f"[data] sim_boost n={N_BOOST} p={P_BOOST}: binned in "
              f"{time.perf_counter() - t0:.2f} s, {int(ds.num_bins)} bins",
              flush=True)
        phase_segment_large(torch, histogram, ds, segment)
        masked, block = phase_masked_kernels(torch, histogram, ds)
        # hist_block has no caller in either package: its count reads 0
        masked["launches"], block["launches"], \
            segment["launches_n200k_p50_one_round"], ref = phase_parallel(
            torch, gpt, histogram, ds, X, y)
        phase_two_ranks(torch, gpt, X, y, ref)
    if (9, 14) in groups:
        Xg, _, yg = sim_grouped(N_GROUPED, Q_GROUPED)
        dsg = gpt.Dataset(Xg, label=yg)
        dsg.construct()
        phase_segment_grouped(torch, histogram, dsg, segment)
        segment["launches_grouped_n100k"] = phase_grouped_slice(
            torch, gpt, histogram)
        phase_grouped_goldens(torch, gpt)
        phase_grouped_card_vs_cpu(torch, gpt)
        phase_gaussian_fits(torch, gpt)
        phase_vecchia_headline(torch, gpt)
    if (15, 19) in groups:
        t_laplace = time.perf_counter()
        phase_glmm(torch, gpt)
        segment["launches_lagaboost_n100k"] = phase_lagaboost(torch, gpt,
                                                              histogram)
        phase_lagaboost_goldens(torch, gpt)
        phase_laplace_card_vs_cpu(torch, gpt)
        print(f"[laplace] phases 15-19 in "
              f"{time.perf_counter() - t_laplace:.1f} s", flush=True)
    cov_dense64 = None
    if (20, 22) in groups:
        t_vl = time.perf_counter()
        cov_dense64 = phase_vecchia_laplace(torch, gpt)
        phase_segment_vl(torch, gpt, histogram, segment)
        segment["launches_lagaboost_vecchia_n20k"] = \
            phase_vecchia_lagaboost(torch, gpt, histogram)
        phase_vecchia_laplace_card_vs_cpu(torch, gpt)
        print(f"[vecchia-laplace] phases 20-22 in "
              f"{time.perf_counter() - t_vl:.1f} s", flush=True)
    t_it = time.perf_counter()
    if (23, 23) in groups:
        phase_iterative_pieces(torch, gpt)
    if (24, 24) in groups:
        if cov_dense64 is None:     # phase 20's float64 fit
            coords, y = sim_vl(N_VL)
            cov_dense64 = _vl_fit(torch, gpt, coords, y,
                                  "float64")[0].get_cov_pars()
        phase_vecchia_laplace_iterative(torch, gpt, cov_dense64)
    if (25, 25) in groups:
        segment["launches_lagaboost_vecchia_n50k_iterative"] = \
            phase_vecchia_lagaboost_iterative(torch, gpt, histogram, segment,
                                              args.vlb_maxit)
    if (26, 26) in groups:
        phase_iterative_card_vs_cpu(torch, gpt)
    print(f"[iterative] phases 23-26 in {time.perf_counter() - t_it:.1f} s",
          flush=True)
    if (27, 29) in groups:
        t_g = time.perf_counter()
        phase_vecchia_pred(torch, gpt)
        segment["launches_gpboost_weighted_n100k"] = phase_weights_clusters(
            torch, gpt, histogram)
        segment["launches_nesterov_w_gpboost1000"] = phase_nesterov(
            torch, gpt, histogram)
        print(f"[gaussian-rest] phases 27-29 in "
              f"{time.perf_counter() - t_g:.1f} s", flush=True)
    if (30, 32) in groups:
        t_m = time.perf_counter()
        if ds is None:      # phases 6-8's binned Dataset
            X, y = sim_boost()
            ds = gpt.Dataset(X, label=y)
            ds.construct()
        segment["launches_objectives_n200k_p50"] = phase_objectives(
            torch, gpt, histogram, ds, y)
        segment["launches_validation_n200k_p50"] = phase_validation(
            torch, gpt, histogram, ds, y)
        segment["launches_cv_grouped_n20k"] = phase_cv(torch, gpt, histogram)
        print(f"[model-selection] phases 30-32 in "
              f"{time.perf_counter() - t_m:.1f} s", flush=True)
    if (33, 35) in groups:
        t_a = time.perf_counter()
        segment["launches_fitc_gpboost_n10k"] = phase_fitc(torch, gpt,
                                                           histogram)
        segment["launches_fitc_lagaboost_n50k"] = phase_fitc_laplace(
            torch, gpt, histogram)
        phase_taper(torch, gpt)
        print(f"[approximations] phases 33-35 in "
              f"{time.perf_counter() - t_a:.1f} s", flush=True)
    if (36, 38) in groups:
        t_c = time.perf_counter()
        segment["launches_lagaboost_combined_n50k"] = phase_combined(
            torch, gpt, histogram)
        segment["launches_gpboost_combined_n20k"] = phase_combined_more(
            torch, gpt, histogram)
        phase_combined_card_vs_cpu(torch, gpt)
        print(f"[combined] phases 36-38 in "
              f"{time.perf_counter() - t_c:.1f} s", flush=True)
    if (39, 41) in groups:
        t_s = time.perf_counter()
        segment["launches_gpboost_svc_n5k"] = phase_svc(torch, gpt,
                                                        histogram, segment)
        segment["launches_lagaboost_svc_n2k"] = phase_adam_svc_laplace(
            torch, gpt, histogram, segment)
        phase_svc_card_vs_cpu(torch, gpt)
        print(f"[svc] phases 39-41 in {time.perf_counter() - t_s:.1f} s",
              flush=True)
    if (42, 44) in groups:
        t_f = time.perf_counter()
        segment["launches_lagaboost_zi_regression_n100k"] = \
            phase_zi_lagaboost(torch, gpt, histogram)
        phase_families_engines(torch, gpt)
        phase_families_card_vs_cpu(torch, gpt)
        print(f"[families] phases 42-44 in "
              f"{time.perf_counter() - t_f:.1f} s", flush=True)
    if (45, 47) in groups:
        t_b = time.perf_counter()
        segment["launches_gpboost_space_time_n100k"] = phase_space_time(
            torch, gpt, histogram)
        phase_matern_shape(torch, gpt)
        phase_breadth_card_vs_cpu(torch, gpt)
        print(f"[breadth] phases 45-47 in "
              f"{time.perf_counter() - t_b:.1f} s", flush=True)
    if (48, 50) in groups:
        t_t = time.perf_counter()
        segment["launches_tabular_n200k_p50"] = phase_tabular(
            torch, gpt, histogram, segment)
        segment["launches_tabular_gpboost_n100k"] = phase_tabular_gpboost(
            torch, gpt, histogram)
        phase_tabular_card_vs_cpu(torch, gpt, histogram, segment)
        print(f"[tabular] phases 48-50 in "
              f"{time.perf_counter() - t_t:.1f} s", flush=True)
    if (51, 53) in groups:
        t_m = time.perf_counter()
        X, y = sim_boost()
        if ds is None:      # phases 6-8's binned Dataset
            ds = gpt.Dataset(X, label=y)
            ds.construct()
        segment["launches_modes_n200k_p50"] = phase_modes(
            torch, gpt, histogram, ds, X, y, segment)
        segment["launches_modes_objectives"] = phase_modes_objectives(
            torch, gpt, histogram, ds, X, segment)
        phase_modes_card_vs_cpu(torch, gpt)
        print(f"[modes] phases 51-53 in "
              f"{time.perf_counter() - t_m:.1f} s", flush=True)
    if args.phases is not None:
        print(f"[chip_smoke] phases {args.phases} done; a partial run "
              "prints no result lines", flush=True)
        return
    print(json.dumps({"kernels": [segment, masked, block]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase: report and exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
