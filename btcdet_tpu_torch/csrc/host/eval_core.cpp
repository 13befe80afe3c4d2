// Host core of the official KITTI AP metric (the per-image tp/fp/fn
// assignment loops), compiled with g++ and driven through ctypes by
// btcdet_tpu_torch/eval/kitti_eval.py. The reference implements these
// with numba-jitted Python (`kitti_object_eval_python/eval.py:164-345`);
// kitti_eval.compute_statistics_plain is the numpy twin.
//
// Semantics follow the official devkit / SECOND implementation:
//   - greedy per-gt assignment; when compute_fp, prefer the
//     highest-overlap non-ignored det; otherwise the highest-score det
//   - ignored gts (difficulty/neighbor-class) absorb dets without tp
//   - dontcare boxes absorb unassigned dets (image metric only)
//   - AOS accumulates (1 + cos(delta_alpha)) / 2 for tps, in tp order

#include <cmath>
#include <cstdint>

extern "C" {

const int NO_DETECTION = -10000000;

// overlaps: [det_size, gt_size] row-major
// gt_ignored / det_ignored: -1 skip, 0 normal, 1 ignored-class
// returns tp, fp, fn, similarity, and (optionally) the scores of tps
void compute_statistics(
    const double* overlaps, int det_size, int gt_size,
    const double* dt_scores, const double* gt_alphas, const double* dt_alphas,
    const int* ignored_gt, const int* ignored_det,
    const double* dc_overlaps, int dc_size,  // [det_size, dc_size] overlap w/ dontcare
    int metric, double min_overlap, double thresh,
    int compute_fp, int compute_aos,
    // outputs
    int* out_tp, int* out_fp, int* out_fn, double* out_similarity,
    double* out_thresholds, int* out_thresh_count)
{
    int tp = 0, fp = 0, fn = 0;
    double similarity = 0.0;
    int thresh_count = 0;

    bool* assigned = new bool[det_size]();
    bool* ignored_threshold = new bool[det_size]();
    if (compute_fp) {
        for (int i = 0; i < det_size; i++)
            if (dt_scores[i] < thresh) ignored_threshold[i] = true;
    }

    double* delta = new double[gt_size];
    int delta_count = 0;

    for (int i = 0; i < gt_size; i++) {
        if (ignored_gt[i] == -1) continue;
        int det_idx = -1;
        double valid_detection = NO_DETECTION;
        double max_overlap = 0.0;
        bool assigned_ignored_det = false;

        for (int j = 0; j < det_size; j++) {
            if (ignored_det[j] == -1) continue;
            if (assigned[j]) continue;
            if (ignored_threshold[j]) continue;
            double overlap = overlaps[(size_t)j * gt_size + i];
            double dt_score = dt_scores[j];
            if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
                det_idx = j;
                valid_detection = dt_score;
            } else if (compute_fp && overlap > min_overlap
                       && (overlap > max_overlap || assigned_ignored_det)
                       && ignored_det[j] == 0) {
                max_overlap = overlap;
                det_idx = j;
                valid_detection = 1;
                assigned_ignored_det = false;
            } else if (compute_fp && overlap > min_overlap
                       && valid_detection == NO_DETECTION
                       && ignored_det[j] == 1) {
                det_idx = j;
                valid_detection = 1;
                assigned_ignored_det = true;
            }
        }

        if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
            fn += 1;
        } else if (valid_detection != NO_DETECTION
                   && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
            assigned[det_idx] = true;
        } else if (valid_detection != NO_DETECTION) {
            tp += 1;
            out_thresholds[thresh_count++] = dt_scores[det_idx];
            if (compute_aos)
                delta[delta_count++] = gt_alphas[i] - dt_alphas[det_idx];
            assigned[det_idx] = true;
        }
    }

    if (compute_fp) {
        for (int j = 0; j < det_size; j++) {
            if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1
                  || ignored_threshold[j]))
                fp += 1;
        }
        // dontcare absorption (image bbox metric only)
        int nstuff = 0;
        if (metric == 0 && dc_size > 0) {
            for (int j = 0; j < det_size; j++) {
                if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1
                    || ignored_threshold[j])
                    continue;
                for (int k = 0; k < dc_size; k++) {
                    if (dc_overlaps[(size_t)j * dc_size + k] > min_overlap) {
                        assigned[j] = true;
                        nstuff += 1;
                        break;
                    }
                }
            }
        }
        fp -= nstuff;
        if (compute_aos) {
            for (int k = 0; k < delta_count; k++)
                similarity += (1.0 + cos(delta[k])) / 2.0;
            // fp contributes 0 similarity (handled by normalization)
        }
    }

    *out_tp = tp;
    *out_fp = fp;
    *out_fn = fn;
    *out_similarity = similarity;
    *out_thresh_count = thresh_count;

    delete[] assigned;
    delete[] ignored_threshold;
    delete[] delta;
}

}  // extern "C"
