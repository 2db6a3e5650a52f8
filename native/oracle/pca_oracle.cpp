// Oracle tool for the reference's custom PCA white balance
// (raw_image_pipeline/modules/white_balance.cpp:73-136): runs the same
// OpenCV call sequence (split/convertTo/multiply/sum/minMaxLoc, the 2x2
// f32 solve, MatExpr scaled add == cv::addWeighted, THRESH_TRUNC,
// convertTo CV_8U) against the system libopencv 4.6 and writes the
// balanced output plus the per-frame scalars (hex floats) for
// stage-by-stage comparison with the JAX implementation.
//
// Eigen is not installed on this machine; the reference's
//     Eigen::Matrix2f m; m << s2, s, m2, mx;   x = m.inverse() * g;
// is reproduced by hand with Eigen's own compute_inverse_size2 algorithm
// (adjugate * (1/det), then the coefficient-wise 2x2 * 2x1 product), all
// in f32 like Matrix2f. Built WITHOUT -mfma, matching a default catkin
// x86-64 build of the reference (no fp contraction available).
#include <cstdio>
#include <cstring>
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

static void solve2x2(float s2, float s, float m2, float m,
                     float sg, float mg, float* x0, float* x1) {
    // Eigen compute_inverse_size2: invdet = 1/(m00*m11 - m01*m10);
    // inv = [m11, -m01; -m10, m00] * invdet; then inv * [sg, mg]
    float det = s2 * m - s * m2;
    float invdet = 1.0f / det;
    float i00 = m * invdet, i01 = -s * invdet;
    float i10 = -m2 * invdet, i11 = s2 * invdet;
    *x0 = i00 * sg + i01 * mg;
    *x1 = i10 * sg + i11 * mg;
}

int main(int argc, char** argv) {
    if (argc < 3) {
        std::fprintf(stderr, "usage: %s <in.png> <out.png>\n", argv[0]);
        return 2;
    }
    cv::Mat image = cv::imread(argv[1], cv::IMREAD_COLOR);
    if (image.empty()) { std::fprintf(stderr, "cannot read %s\n", argv[1]); return 1; }

    // --- reference call sequence (white_balance.cpp:73-136) ---
    std::vector<cv::Mat> split_img;
    cv::split(image, split_img);
    split_img[0].convertTo(split_img[0], CV_32FC1);
    split_img[2].convertTo(split_img[2], CV_32FC1);

    cv::Mat I_r_2, I_b_2;
    cv::multiply(split_img[0], split_img[0], I_b_2);
    cv::multiply(split_img[2], split_img[2], I_r_2);

    const double sum_I_r_2 = cv::sum(I_r_2)[0];
    const double sum_I_b_2 = cv::sum(I_b_2)[0];
    const double sum_I_g = cv::sum(split_img[1])[0];
    const double sum_I_r = cv::sum(split_img[2])[0];
    const double sum_I_b = cv::sum(split_img[0])[0];

    double max_I_r, max_I_g, max_I_b, max_I_r_2, max_I_b_2;
    double min_unused;
    cv::minMaxLoc(split_img[2], &min_unused, &max_I_r);
    cv::minMaxLoc(split_img[1], &min_unused, &max_I_g);
    cv::minMaxLoc(split_img[0], &min_unused, &max_I_b);
    cv::minMaxLoc(I_r_2, &min_unused, &max_I_r_2);
    cv::minMaxLoc(I_b_2, &min_unused, &max_I_b_2);

    // Matrix2f/Vector2f fill narrows the doubles to f32
    float x0_b, x1_b, x0_r, x1_r;
    solve2x2((float)sum_I_b_2, (float)sum_I_b, (float)max_I_b_2, (float)max_I_b,
             (float)sum_I_g, (float)max_I_g, &x0_b, &x1_b);
    solve2x2((float)sum_I_r_2, (float)sum_I_r, (float)max_I_r_2, (float)max_I_r,
             (float)sum_I_g, (float)max_I_g, &x0_r, &x1_r);

    // MatExpr  f*A + f*B  evaluates via cv::addWeighted(A, f, B, f, 0)
    cv::Mat b_point, r_point;
    cv::addWeighted(I_b_2, x0_b, split_img[0], x1_b, 0.0, b_point);
    cv::addWeighted(I_r_2, x0_r, split_img[2], x1_r, 0.0, r_point);

    cv::threshold(b_point, b_point, 255, 255, cv::THRESH_TRUNC);
    cv::threshold(r_point, r_point, 255, 255, cv::THRESH_TRUNC);
    b_point.convertTo(b_point, CV_8UC1);
    r_point.convertTo(r_point, CV_8UC1);

    std::vector<cv::Mat> channels;
    channels.push_back(b_point);
    channels.push_back(split_img[1]);  // green was never convertTo'd: still u8
    channels.push_back(r_point);
    cv::Mat merged;
    cv::merge(channels, merged);
    cv::imwrite(argv[2], merged);

    auto hex = [](double v) { return v; };
    std::printf("sums  b2=%.17g b=%.17g g=%.17g r=%.17g r2=%.17g\n",
                hex(sum_I_b_2), hex(sum_I_b), hex(sum_I_g), hex(sum_I_r), hex(sum_I_r_2));
    std::printf("maxes b2=%.17g b=%.17g g=%.17g r=%.17g r2=%.17g\n",
                max_I_b_2, max_I_b, max_I_g, max_I_r, max_I_r_2);
    unsigned ux0b, ux1b, ux0r, ux1r;
    std::memcpy(&ux0b, &x0_b, 4); std::memcpy(&ux1b, &x1_b, 4);
    std::memcpy(&ux0r, &x0_r, 4); std::memcpy(&ux1r, &x1_r, 4);
    std::printf("coef  x0b=%08x x1b=%08x x0r=%08x x1r=%08x\n", ux0b, ux1b, ux0r, ux1r);
    std::printf("ok pca %dx%d\n", merged.cols, merged.rows);
    return 0;
}
