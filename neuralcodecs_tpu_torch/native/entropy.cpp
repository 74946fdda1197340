// Native range coder for .ecdc entropy coding.
//
// Copy of neuralcodecs_tpu/native/entropy.cpp: the serial bit-carry loops of
// the reference coder (ArithmeticCoder, ArithmeticDecoder, BitPacker and
// BitUnpacker of NeuralCodecs.Torch/Modules/Encodec). Byte-exact with the
// Python coder in models/encodec/entropy.py (held by
// tests/test_torch_entropy.py), ~100x faster on the per-symbol loop. This is
// host code, not a kernel: compression encodes a whole entry's symbols in one
// call (its pdfs gathered from the LM step loop); decompression keeps a
// stateful handle because each decoded symbol feeds the next LM step.
//
// Build (native/build.py does it at first use):
//   g++ -O2 -shared -fPIC -std=c++17 -o libncentropy.so entropy.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t current = 0;
    int bits = 0;

    void push_bit(int b) {
        current |= static_cast<uint64_t>(b & 1) << bits;
        if (++bits == 8) {
            out.push_back(static_cast<uint8_t>(current & 0xFF));
            current = 0;
            bits = 0;
        }
    }
    void flush() {
        if (bits > 0) {
            out.push_back(static_cast<uint8_t>(current & 0xFF));
            current = 0;
            bits = 0;
        }
    }
};

struct Coder {
    int total_range_bits;
    int64_t low = 0, high = 0;
    int max_bit = -1;
    BitWriter writer;

    int64_t delta() const { return high - low + 1; }

    // returns 0 on success, -1 on invalid range
    int push(int symbol, const int64_t* cdf) {
        while (delta() < (int64_t(1) << total_range_bits)) {
            low *= 2;
            high = high * 2 + 1;
            ++max_bit;
        }
        const int64_t range_low = symbol == 0 ? 0 : cdf[symbol - 1];
        const int64_t range_high = cdf[symbol] - 1;
        const double scale =
            static_cast<double>(delta()) /
            static_cast<double>(int64_t(1) << total_range_bits);
        const int64_t eff_low =
            static_cast<int64_t>(std::ceil(range_low * scale));
        const int64_t eff_high =
            static_cast<int64_t>(std::floor(range_high * scale));
        if (eff_low > eff_high) return -1;
        high = low + eff_high;
        low = low + eff_low;
        while (max_bit >= 0) {
            const int b1 = static_cast<int>((low >> max_bit) & 1);
            const int b2 = static_cast<int>((high >> max_bit) & 1);
            if (b1 != b2) break;
            low -= static_cast<int64_t>(b1) << max_bit;
            high -= static_cast<int64_t>(b1) << max_bit;
            --max_bit;
            writer.push_bit(b1);
        }
        if (max_bit > 61) return -2;
        return 0;
    }

    void flush() {
        while (max_bit >= 0) {
            writer.push_bit(static_cast<int>((low >> max_bit) & 1));
            --max_bit;
        }
        writer.flush();
    }
};

struct Decoder {
    int total_range_bits;
    const uint8_t* data;
    int64_t size;
    int64_t byte_pos = 0;
    uint64_t bit_buf = 0;
    int bit_count = 0;
    int64_t low = 0, high = 0, current = 0;
    int max_bit = -1;

    int64_t delta() const { return high - low + 1; }

    int pull_bit() {  // -1 at EOF
        if (bit_count == 0) {
            if (byte_pos >= size) return -1;
            bit_buf = data[byte_pos++];
            bit_count = 8;
        }
        const int b = static_cast<int>(bit_buf & 1);
        bit_buf >>= 1;
        --bit_count;
        return b;
    }

    // returns symbol >=0, or -1 at end of stream, -2 on search failure
    int pull(const int64_t* cdf, int card) {
        while (delta() < (int64_t(1) << total_range_bits)) {
            const int bit = pull_bit();
            if (bit < 0) return -1;
            low *= 2;
            high = high * 2 + 1;
            current = current * 2 + bit;
            ++max_bit;
        }
        const double scale =
            static_cast<double>(delta()) /
            static_cast<double>(int64_t(1) << total_range_bits);
        int lo_idx = 0, hi_idx = card - 1;
        int symbol = -2;
        while (lo_idx <= hi_idx) {
            const int mid = (lo_idx + hi_idx) / 2;
            const int64_t range_low = mid > 0 ? cdf[mid - 1] : 0;
            const int64_t range_high = cdf[mid] - 1;
            const int64_t eff_low =
                static_cast<int64_t>(std::ceil(range_low * scale)) + low;
            const int64_t eff_high =
                static_cast<int64_t>(std::floor(range_high * scale)) + low;
            if (current >= eff_low && current <= eff_high) {
                symbol = mid;
                low = eff_low;
                high = eff_high;
                break;
            }
            if (current > eff_high) {
                lo_idx = mid + 1;
            } else {
                hi_idx = mid - 1;
            }
        }
        if (symbol < 0) return -2;
        while (max_bit >= 0) {
            const int b1 = static_cast<int>((low >> max_bit) & 1);
            const int b2 = static_cast<int>((high >> max_bit) & 1);
            if (b1 != b2) break;
            low -= static_cast<int64_t>(b1) << max_bit;
            high -= static_cast<int64_t>(b1) << max_bit;
            current -= static_cast<int64_t>(b1) << max_bit;
            --max_bit;
        }
        return symbol;
    }
};

}  // namespace

extern "C" {

// Encode n symbols, each with its own CDF row (cdfs: [n, card] int64,
// row-major). Writes up to out_cap bytes into out; returns the number of
// bytes produced, or a negative error code.
long long nc_ac_encode(const long long* cdfs, const int* symbols,
                       long long n, int card, int total_range_bits,
                       unsigned char* out, long long out_cap) {
    Coder coder;
    coder.total_range_bits = total_range_bits;
    for (long long i = 0; i < n; ++i) {
        const int rc = coder.push(symbols[i],
                                  reinterpret_cast<const int64_t*>(cdfs) + i * card);
        if (rc != 0) return -100 + rc;
    }
    coder.flush();
    if (static_cast<long long>(coder.writer.out.size()) > out_cap) return -1;
    std::memcpy(out, coder.writer.out.data(), coder.writer.out.size());
    return static_cast<long long>(coder.writer.out.size());
}

// Stateful decoder handle API (decode needs per-symbol LM feedback).
void* nc_ad_new(const unsigned char* data, long long size,
                int total_range_bits) {
    auto* d = new Decoder();
    d->total_range_bits = total_range_bits;
    // copy so the Python buffer may be freed
    auto* copy = new uint8_t[size];
    std::memcpy(copy, data, size);
    d->data = copy;
    d->size = size;
    return d;
}

int nc_ad_pull(void* handle, const long long* cdf, int card) {
    return static_cast<Decoder*>(handle)->pull(
        reinterpret_cast<const int64_t*>(cdf), card);
}

// Pull a group of `count` symbols sharing one batch of CDFs
// (cdfs: [count, card]); returns number decoded (stops early at EOF).
int nc_ad_pull_many(void* handle, const long long* cdfs, int count, int card,
                    int* out_symbols) {
    auto* d = static_cast<Decoder*>(handle);
    for (int i = 0; i < count; ++i) {
        const int s = d->pull(
            reinterpret_cast<const int64_t*>(cdfs) + static_cast<long long>(i) * card,
            card);
        if (s < 0) return i;
        out_symbols[i] = s;
    }
    return count;
}

void nc_ad_free(void* handle) {
    auto* d = static_cast<Decoder*>(handle);
    delete[] d->data;
    delete d;
}

}  // extern "C"
