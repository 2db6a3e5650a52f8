// Oracle tool: runs OpenCV 4.6 xphoto white-balance implementations
// (SimpleWB, GrayworldWB, LearningBasedWB) on an input image and writes the
// balanced output. Used to generate golden fixtures for the JAX
// implementations (reference calls: raw_image_pipeline/modules/
// white_balance.cpp:52-71).
#include <cstdio>
#include <string>
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/xphoto/white_balance.hpp>

int main(int argc, char** argv) {
    if (argc < 4) {
        std::fprintf(stderr,
            "usage: %s <in.png> <out.png> simple <p>|grey <thr>|learned <thr> [model.yml]\n",
            argv[0]);
        return 2;
    }
    cv::Mat img = cv::imread(argv[1], cv::IMREAD_COLOR);
    if (img.empty()) { std::fprintf(stderr, "cannot read %s\n", argv[1]); return 1; }
    std::string method = argv[3];
    cv::Mat out;
    if (method == "simple") {
        // reference: white_balance.cpp:52-57
        auto wb = cv::xphoto::createSimpleWB();
        float p = argc > 4 ? std::atof(argv[4]) : 20.f;
        wb->setP(p);
        wb->balanceWhite(img, out);
    } else if (method == "grey") {
        // reference: white_balance.cpp:59-64
        auto wb = cv::xphoto::createGrayworldWB();
        float thr = argc > 4 ? std::atof(argv[4]) : 0.8f;
        wb->setSaturationThreshold(thr);
        wb->balanceWhite(img, out);
    } else if (method == "learned") {
        // reference: white_balance.cpp:66-71
        auto wb = cv::xphoto::createLearningBasedWB(argc > 5 ? argv[5] : "");
        float thr = argc > 4 ? std::atof(argv[4]) : 0.8f;
        wb->setSaturationThreshold(thr);
        wb->balanceWhite(img, out);
    } else {
        std::fprintf(stderr, "unknown method %s\n", method.c_str());
        return 2;
    }
    cv::imwrite(argv[2], out);
    std::printf("ok %s %dx%d\n", method.c_str(), out.cols, out.rows);
    return 0;
}
